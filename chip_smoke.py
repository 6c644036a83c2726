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
   at small, ragged and full size: the slot kernels K1/K2, K1's pointer
   form (the deposits read in place) bitwise on nine dtypes, sum and
   mean, R = 1, 2, 3, 8, n = 1 to 16 Mi, aligned and at a 1-element
   offset (its element instance), then the ring
   kernels: K3 (the direct fold) bit for bit on nine dtypes and the four
   ops, one and two ring directions, its vector and scalar paths, p up
   to 64, 2 and 4 lines, NaN and signed zeros under max and min, and 8 x
   64 MiB f32 on both paths; K5 (the direct gather) bit for bit on f32,
   i32, i16, i8 and u8, shards at element offset 1, over 1 and 2 lines
   up to 8 x 64 MiB, and the direct K6/K7 bit for bit at p = 2, 3,
   5, 8 and 64 on eight dtypes, on their vector and scalar paths (blocks
   of whole 16-byte words and odd ones, shards aligned and at element
   offset 1), at 64 KiB and at their 4 MiB limit; the alltoall kernels
   K10/K11 (K11's direct copy by tile table; K10 over the uniform plan's
   table) bitwise (K10 on f32, bf16, i32 and u8, K11 also on f16, i8
   and u16) under the TPU schedule's depth 2/3/4 and one and two lanes
   (which shape nothing), a ragged block, the MoE
   bench's three routing matrices at p = 8, 3 and 2, a matrix with
   zero-count pairs and a step empty on every rank, K11 payloads at
   element offset 1 and spread displacements with out_len, K10 at 64
   MiB a rank and K11 at the full MoE width; the flash kernels K15/K16
   against their plain versions with full f32 products (causal and
   full, q0/k0 offsets with wholly-future
   and wholly-past blocks, gcd-shrunk blocks, f32/bf16/f16, head widths
   16 to 256, and the attention paths' full-width launches), and the
   plain version with TF32 on, which must fall outside the tolerance;
   then K4 (the ring reduce-scatter as K3's direct fold kept to each
   block's owner) bitwise on the nine dtypes and the four ops, small
   and ragged sizes (padded tails), NaN and signed zeros under max and
   min, one and two directions, lines 1/2/4, the (2, 4) mesh's RS-x
   phase and 8 x 64 MiB f32; K3 and K5 over 2 and 4 lines; K8
   (sendrecv, the bulk-copy pipeline) bitwise on f32, bf16, i32 and u8,
   an unaligned n, src == dst, shards at 1-3 elements' offset (heads and
   tails; rows copied element by element, counted against k8_plan), n
   just below and above a tile, and 8 x 64 MiB;
4. main path: 8 ranks (run_ranks) allreduce 64 MiB f32 tensors each on
   cuda:0 through the slot channel into K1 (reading the deposits in
   place, hbm.PATHS checked), plus the small collectives and one
   allreduce whose send buffers are written as soon as it returns, then
   the one-chip bench candidates (K1 and K2) at the same size; the
   kernels' launch counts are zeroed before it and read after;
5. mesh path: 8 ranks bound one to one to a mesh of 8 virtual ranks on
   cuda:0 (run_ranks(device_mesh=make_mesh(...))): allreduce of 64 MiB
   (K3) and 64 KiB (K6), allgathers of 1 MiB (K5) and 64 KiB (K7), a max
   allreduce, reduce, bcast, reduce_scatter_block, each checked; the
   ring kernels' launch counts are zeroed before it and read after, and
   the tier pvars checked;
   fold path: the same 8 ranks over a 4-device virtual mesh, 2 ranks a
   device (the fold channel): allreduce of 64 MiB (4 K1 + 1 K3 a call)
   and 64 KiB (4 K1 + K6), a max (stock fold + K3), reduce, bcast from
   root 5, allgathers of 1 MiB (K5) and 64 KiB (K7),
   reduce_scatter_block, then one allreduce over a 2-device mesh;
   multi-axis path: the 8 ranks 1:1 on a (2, 4) mesh: allreduce of 64 MiB
   (2 K4 + 2 K5 a call) and 1 KiB (2 K3), allgather of 1 MiB (2 K5),
   reduce_scatter_block (2 K4), bcast, a stock alltoall (no K10), a max,
   then one allreduce on a (4, 2) mesh; each with its launch counts
   zeroed just before and read after, the level and tier pvars checked
   and every result held against the plain reduction; then K8, the
   exchange a user calls, 3 times at 8 x 64 MiB;
6. mesh alltoall path: the same binding, comm.alltoall of 64 MiB f32 a
   rank (K10) and comm.alltoallv of the MoE bench's hot routing at
   Mixtral-8x7B width, 4096 tokens x 4096 f32 a rank (K11), each held
   against numpy; K10/K11's launch counts zeroed before and read after,
   the tier pvar checked (8 per call);
7. moe: the port's MoE step bench (mvapich2_tpu_torch.bench.moe) at
   --tokens 4096 --dmodel 4096 on the card, all three routing shapes,
   one step of it held against the plain versions and x @ W;
8. rma: the one-sided device windows. First (under [kernels]) the RMA
   kernels K12/K13/K14/K17 bitwise against their plain versions, every
   window row compared: f32, bf16, f16, i32, i8 and u8, counts below one
   16-byte vector, misaligned disp, partial tail chunks, chunk_bytes 16
   and the default, depth 2/3/4, origin == target at p = 2 and 8, and
   N - 7 elements at disp 5 of a 64 MiB-a-rank window; the direct copy
   of K12/K13/K17 on f32, bf16 and i8 at every disp residue mod 16 bytes,
   sources at offset 0 and 1, counts around the vector width and one
   grid-stride pass; K12, K14 and K17 with a source that overlaps the
   target range, against the plain versions on a cloned source; the
   direct fold of K14 the same way on every kind above, with the exact
   alias; and (with the quant kernels) K14q at blocks of 64, 128 and
   256 values, disp 0 and 5, a misaligned source and the exact alias,
   and K9, the whole quantized allreduce in one launch, bitwise on both
   wires, f32 and f16, blocks of 8 to 2048 values, odd n, shards at
   element offset 1 and 8 x 64 MiB.
   Then the path:
   the OSU one-sided band (mvapich2_tpu_torch.bench.osu_rma, 1 KiB to
   4 MiB, 32 ops a fence, 3 + 12 fences, put/get/accumulate from rank 0
   to rank 7) on a DeviceWin of 64 MiB f32 a rank over 8 virtual ranks,
   its whole-window ops, a lock / 32 puts + get / flush / accumulate /
   unlock epoch and a strided put; the window and every get held against
   a plain replay, the launch counts (zeroed just before) and the
   dev_rma_* pvars checked;
9. attn: sequence-parallel attention at Ouro-2.6B's attention width
   (16 heads x 128, f32, causal) over 8 virtual ranks of 4096 tokens on
   cuda:0, through MeshComm.run: ring_attention_flash (K16, 8 launches
   a call) and ulysses_attention(use_flash=True) (K15, one launch); the
   flash counts zeroed just before each path and read after; ring
   against Ulysses over every row, both against dense f32 attention on
   the last 256 rows of each rank; host-clock latency, median of 5;
10. times, by CUDA events: each kernel beside its bound, its plain
   version and the library call; K1 over the deposits by card time too,
   beside the parent's leader (stack then K1), torch.sum of the stacked
   deposits and torch.stack(deposits).sum(0); the end-to-end
   allreduce latency and effective bandwidth (2*R*m/t) of both paths;
   the end-to-end alltoall latency of the mesh path; the RMA kernels at
   64 MiB, K12/K13/K14 misaligned (N - 7 at disp 5) beside copy_ or add_,
   K12/K13 at 1 KiB and 64 KiB, and the OSU band; K15 and K16 beside
   scaled_dot_product_attention on the same blocks; K4 at 8 x 64 MiB and
   as the (2, 4) RS-x phase (by card time too), K8 at 8 x 64 MiB (by
   card time too, beside torch.stack by partner), and
   the e2e latency of
   the fold and (2, 4) allreduces beside the 1-D mesh call; K6 and K7
   at 8 x 64 KiB and at their 4 MiB limit by card time too (queued
   behind a sleep kernel; at 4 MiB also with L2 evicted), each beside
   its library form that writes every rank's copy; K5 at 8 x 1 MiB and
   as the (2, 4) allreduce's AG-y and AG-x phases by card time too; K10
   at 64 MiB a rank by card time too; K11
   on the hot, skew and uniform MoE dispatch by CUDA events and card
   time, beside one index_select from the concatenated payloads;
11. profiles: the host side of one fence of 32 puts and 32 gets at 1
   KiB (perf_counter splits and cProfile's top entries), then under
   torch.profiler one MoE step of each routing shape, one fence of 32 RMA
   ops (put, get, accumulate at 1 KiB and 4 MiB), one 64 MiB allreduce
   on the slot channel, the 1-D mesh, the fold and the (2, 4) mesh (the
   staging stacks a group of their own), and one call of each
   attention path, under torch.profiler: device time by kernel group
   and the idle share;
12. trace (after every measuring phase, just before the torch.profiler
   profiles, which slow every later host call): five programs under
   MV2T_TRACE, each dumping to a directory of its own (a slot allreduce
   of 8 x 64 MiB f32, 1-D mesh allreduces of 64 MiB and 64 KiB, a fold
   and a (2, 4) mesh allreduce of 64 MiB, and one DeviceWin fence epoch
   and lock/flush/unlock epoch); the dumps checked (every rank dumped,
   every span balanced, each dev_allreduce span's tier the one the tier
   pvars counted, one lat_dev_<tier> / lat_rma_flush record a call) and
   run through bin/mv2tconform, which must exit 0; the median
   dev_allreduce span beside the leader's window of card time on the
   same calls (CUDA events after its deposit waits and after its
   program), the e2e slot allreduce traced and untraced in turns, and a
   split of one slot and one mesh call's host time into deposit, first
   barrier wait, leader, second barrier wait and delivery.

13. nbc (after the attention paths): the nonblocking and persistent
   device collectives on the 1:1 mesh of 8 virtual ranks: iallreduce of
   64 MiB f32 a rank (8 segments of 8 MiB, 8 K3 launches), ibcast of 64
   MiB from numpy buffers (8 segments, stock), iallgather of 1 MiB (K5)
   and 64 KiB (K7), ialltoall of 64 MiB (K10) and ialltoallv of the hot
   MoE routing at full width (K11), all posted, then completed by
   waitall, every request on the device tier and every result bitwise
   the blocking call's; 1001 int32 at 256-byte segments (8 K3 on views
   that are not 16-byte aligned); an iallreduce of 64 MiB on the (2, 4)
   mesh (16 K4 + 16 K5); allreduce_init with 3 starts (every segment
   program built at init, 24 K3, dev_persistent_starts +24); one 64 MiB
   segment whose CUDA event must read not ready right after its launch
   returns; the overlap, recorded with no limit and no claim: each rank
   a 64 MiB allreduce into a numpy buffer then a 4096^2 f32 matmul,
   against iallreduce, the matmul and wait() (median of 5 after 1, and
   the host split of the post, the launches, the polls and the finish);
   a rank that dies after its peers posted (every peer's wait() raises
   MPIX_ERR_PROC_FAILED within seconds); one traced iallreduce whose
   dump bin/mv2tconform passes. Each kernel count is zeroed just before
   its call and read just after.

14. models (after the RMA host profile, just before trace): the models
   slice on virtual ranks of cuda:0. The multi-axis MeshComm.allreduce:
   64 MiB f32 a rank on the (2, 4) mesh, sum and max (2 K4 + 2 K5 a
   call), a 2 KiB shard below DEV_TIER_AXES_MIN (2 K3), the (2, 2, 2)
   mesh over ("dp", "sp") (2 K4 + 2 K5) and over all three axes (3 K4
   + 3 K5; 3 K3 at 2 KiB), each call's counts zeroed just before and
   read after, each result bitwise the stock reduction of its groups on
   integer-valued data, the (2, 4) call's card time by CUDA events; the
   transformer's train step at the default Config() (vocab 256, d_model
   128, 8 heads, 2 layers, d_ff 256, seq 128, batch 8, 4 experts, MoE
   at layer 1) on the (2, 2, 2) ("dp", "sp", "tp") mesh of demo_setup:
   6 steps whose loss must fall, step 1's loss (rtol 1e-5) and new
   params (rtol 1e-4 / atol 1e-5) against the same code on the CPU, the
   dense model's first loss on (1, 1, 1) and (2, 2, 2) within rtol
   1e-3, the median step time (host clock); the 3-D stencil at BASELINE
   config 4's 512^3 f32 grid split on z over 8 ranks, 4 periodic
   iterations, against reference_stencil on the same grid, its time an
   iteration; the graft entry's pipeline demo over 8 stages. The train
   step, the stencil and the pipeline run stock torch (no kernel count
   moves). Last of all, one train step and one stencil iteration under
   torch.profiler (device time by kernel group, kernels launched, the
   idle share).

15. host (after nbc): the in-process host tier. 8 ranks on the slot
   channel and on the 1:1 mesh allreduce numpy f32 at 4 B, 1 KiB, 16 KiB
   - 4, 16 KiB, 64 KiB and 64 MiB (integer-valued, bitwise against
   numpy): below DEVICE_COLL_MIN_BYTES no kernel launches and the
   recursive-doubling counter moves once a rank, at and above it one K1
   (slot) or K6/K3 (mesh) a call; then on the slot channel an f64 1 MiB
   allreduce, a non-commutative user op (gather_bcast),
   gather(v)/scatter(v)/scan/exscan/allgatherv/reduce_scatter, ibarrier/
   ireduce/ireduce_scatter_block/iallreduce, a 7-sender ANY_SOURCE
   receive and a barrier, MV2T_ALLREDUCE_ALGO=ring at 64 KiB, and
   alltoall on the fold channel, with no launch; the rank 0 <-> 1
   ping-pong from 1 B to 4 MiB on two fake nodes (eager to 64 KiB) and
   on one (eager to 32 KiB), the eager/rendezvous pvars checked a size;
   barrier and 4 B to 16 KiB - 4 allreduce latency (host clock, median
   of 50); tensors on the card in calls that the device tier does not
   take (float64, a forced host algorithm, MPI_IN_PLACE alltoallv, a
   split whose members' geometry binds no channel, an iallreduce with
   MPI_IN_PLACE on the slot channel) raise NotImplementedError on every
   rank, with no launch and no copy to the host. Each kernel count is
   zeroed just before its call.
16. graft (after models): mvapich2_tpu_torch.graft_entry's entry()
   forward on a (1, 1, 1) mesh of the card and dryrun_multichip(8) (one
   train step on (2, 2, 2) and the 8-stage pipeline), each against the
   same on the CPU; stock torch, no kernel count moves.
17. mpirun (after graft): the MPI program entry, as a user calls it, in
   subprocesses. ``python -m mvapich2_tpu_torch.run -np 8 --vpod python
   mvapich2_tpu_torch/progs/vpod_collectives.py``: 8 rank threads call
   mpi.Init() and, on COMM_WORLD bound one to one to a mesh of 8 virtual
   ranks on cuda:0, allreduce 64 MiB (K3) and 4 KiB (K6) f32 tensors,
   allgather 1 MiB (K5) and 64 KiB (K7), alltoall 64 MiB (K10) and
   alltoallv a seeded count matrix (K11), each result bitwise against
   stock torch on the card; its launch counts, zeroed at its start, must
   read one K3 a 64 MiB allreduce, one K6 a 4 KiB one and one launch of
   each other kernel; its medians stand beside [mesh]'s run_ranks
   figures. Then ``-np 4 --fake-nodes 0,0,1,1 python
   mvapich2_tpu_torch/progs/pingpong.py``: rank processes on the host
   tier, the numpy ping-pong over shared memory and over TCP at 1 B, 64
   KiB and 4 MiB, an 8 B allreduce, a barrier, mpi.Init's wall time, and
   a tensor on the card given to allreduce must raise
   NotImplementedError; then, in the same job (``--rungs arena,file``),
   the shm ping-pong again at each size under the arena (CMA dropped:
   the pipelined rendezvous) and under the file rung (the arena dropped
   too), each run with the verdicts it ran under and rank 0's rung
   counters, which must name that rung (the default run: CMA where the
   node agreed it). A nonzero exit, a mismatch or a missing refusal
   fails the phase.
18. card_paths (after mpirun): the calls that run on the device for a
   tensor where the JAX package stages them through its host tier
   (bfloat16, alltoall(v) on the slot and fold channels) and the window
   over one axis of a multi-axis mesh, each path through run_ranks(8)
   on cuda:0 with its kernel counts zeroed just before it and read just
   after, ``to_host`` made to fail (no tensor is copied to the host) and
   the tier picks and the stock reduction made to raise on a bfloat16
   call that reaches the stock tier. bfloat16
   allreduce (integers in [-8, 8), every sum exact) at 16 KiB and 64
   MiB a rank on the slot channel (K1), the 1:1 mesh (K6, K3) and 8
   ranks over 2 fold devices (2 K1 + K6 or K3), a 64 MiB max (K3) and
   reduce_scatter_block (K4),
   allgathers of 2 KiB (K7) and 1 MiB (K5), a 64 MiB allreduce (2 K4 +
   2 K5) and reduce_scatter_block (2 K4) on the (2, 4) mesh; alltoallv of
   the MoE bench's hot routing at 4096 x 4096 f32 on the slot channel
   and the fold (K11), a bfloat16 alltoall on the fold (K10); every
   result bitwise the plain one, dev_coll_fallback_dtype and _size
   unmoved; the timed paths' medians on the host clock and on the card
   (CUDA events queued behind a sleep kernel). Then a DeviceWin of 64
   MiB f32 rows over each axis of the (2, 4) mesh: a put, a get and an
   accumulate of 16 MiB (K12, K13, K14) and a direct_put (K17), held
   bitwise against a plain replay, each kernel's card time (queued
   behind a sleep kernel) and each op with its fence on the host clock;
   and K1 and K3 at 8 x 64 MiB in
   bfloat16 beside float32 (the same bytes), by CUDA events.
19. derived (after card_paths): comms made by split and dup, each with
   the device channel its members' geometry gives: the 8-rank slot
   COMM_WORLD split into two comms of 4 (K1), the 1:1 mesh of 8 split
   into even and odd ranks and the (2, 4) mesh into its rows (1:1
   channels over 1-D meshes of 4: K6, K3, K5/K7, K11), the fold
   COMM_WORLD (8 ranks over 2 devices) dup'd (2 K1 + the ring); on each
   a 16 KiB and a 64 MiB f32 allreduce, a 2 MiB allgather and an
   alltoallv of tensors, every result bitwise the plain one, each
   beside the COMM_WORLD of the same k and geometry (its launches a
   comm, times of the derived call and of that call, on the card by
   CUDA events queued behind a sleep kernel and on the host clock,
   medians of 5); then on the slot and the fold channel iallreduce of
   64 MiB (8 segments), ialltoallv and allreduce_init with 3 starts
   into tensors, every request on the device NBC tier and bitwise the
   plain result, and iallreduce + wait beside the blocking allreduce on
   the host clock, with the i-call's host split (the posts and the
   deposits' arrival, the segment launches, the card's run seen through
   the polls, the finishes and their landing copies), under Python's
   GIL switch interval and again under 0.5 ms. ``to_host`` fails
   throughout; each kernel count is
   zeroed just before its path and read just after.
20. spawn (after derived): dynamic processes and intercomms. (a) 4 rank
   threads on cuda:0 (the slot channel) spawn 4 rank threads from a
   callable (8 ranks); over the spawn intercomm allreduce, bcast (ROOT
   and PROC_NULL on the parents), allgather, alltoall,
   reduce_scatter_block and the i-calls iallreduce, ibcast, iallgather
   and ialltoall of numpy f32 at 4 B, 64 KiB and 4 MiB a rank, integer
   values, every result bitwise numpy's on every rank and each call
   timed (median of 5 after one, rank 0's host clock), and the 4 MiB
   allreduce's parts alone (local reduce, leaders' exchange, local
   bcast); then merge(high) and a 4 MiB allreduce over the 8-rank
   merged comm; a
   tensor on the card in a call on the intercomm and on the merged comm
   raises NotImplementedError naming why, on all 8 ranks; the kernel
   counts, zeroed before the run, read zero after those calls; then
   the parents' COMM_WORLD allreduces 64 MiB f32 tensors through K1
   (its count zeroed just before: one launch), bitwise its plain
   version. (b) 8 rank threads split in halves: Open_port and
   Publish_name, Lookup_name, Comm_accept / Comm_connect, a 4 MiB
   intercomm allreduce, disconnect and Unpublish_name. (c) ``python -m
   mvapich2_tpu_torch.run -np 2 python
   mvapich2_tpu_torch/progs/spawn_parent.py``: Comm_spawn_multiple of 2
   child processes (appnum 0 and 1), the job's wall time, rank 0's
   Comm_spawn time and the intercomm allreduce at 8 B and 4 MiB; the
   job must print No Errors and no child may outlive it.

The line before the last is a JSON object {"kernels": [...]}; the last
is {"ok": true, "device": {...}}. Any failure raises. ``--sweep`` runs
only phases 1 and 2, then the launch-shape sweeps of K9
(``phase_sweep``: threads per block x loads in flight), of the K12/K13 copy
(``phase_copy_sweep``), of K8's bulk-copy pipeline (``phase_k8_sweep``)
and of K1's pointer form (``phase_k1_sweep``), which chose the launch
shapes in ``coll/tuning.py``, and of K11's tile size
(``phase_tile_sweep``), which chose ``alltoall.TILE_BYTES``;
``--sweeps k8,k1`` runs some of them.
"""

import argparse
import collections
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
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
TF32_PEAK_TFLOPS = 495.0           # dense TF32 on the tensor cores
SOURCES = ("hbm_slot", "ring", "flash")   # mvapich2_tpu_torch/csrc/<name>.cu
# ring kernels whose registers and spills [build] prints
REG_REPORT = ("remote_sendrecv",)
# element types of the K12/K13 copy and K11 instances, as their names
# mangle them
COPY_TYPES = {"j": "u32", "t": "u16", "h": "u8"}
# the K3/K6, K4 and K7/K5 instances whose registers [build] prints: the
# f32 fold of K3 and K4 on both paths (sum; max too on the word path,
# with its NaN branch), the gather's word and 4-byte element
DIRECT_TYPES = {"ffLi0": "float, float, sum",
                "f5uint4Li0": "float, uint4, sum",
                "f5uint4Li1": "float, uint4, max", "5uint4": "uint4",
                "j": "u32"}
RMA_KINDS = ("f32", "bf16", "f16", "i32", "i8", "u8", "u16", "u32")
# the nine dtypes of K3's fold, and its float ones with their torch names
K3_KINDS = ("f32", "f16", "bf16", "i32", "i16", "i8", "u8", "u16", "u32")
K3_FLOATS = {"f32": "float32", "f16": "float16", "bf16": "bfloat16"}
# integer kinds compared bit for bit; uint16/uint32 have their plain
# versions run on the CPU (torch's CUDA build implements few operations
# for them) and are compared through a same-width signed view
BITWISE = ("f32int", "i32", "i16", "i8", "u8", "u16", "u32")
UINT_VIEW = {"torch.uint16": "int16", "torch.uint32": "int32"}
# the quant tier's main path: MV2T_QUANT_COLL budgets (q8 5e-2 covers
# declared_bound(8, "q8") = 0.0315, fp8 0.3 covers 0.286), and the bytes
# one rank keeps off the ring a 64 MiB f32 call (wire_stats: 117,440,512
# exact - 30,277,632 quantized)
QUANT_SPECS = (("5e-2", "q8"), ("fp8:0.3", "fp8"))
QUANT_SAVED = 87162880
SMALL_MESH = 16 * 1024             # f32 elements: 64 KiB a rank (K6, K7)
AG_MESH = 256 * 1024               # f32 elements: 1 MiB a rank (K5)
RESIDENT_FULL = 1024 * 1024        # f32 elements: 4 MiB, the K6 limit
# the MoE step at Mixtral-8x7B width (config.json of
# mistralai/Mixtral-8x7B-v0.1: hidden_size 4096, num_local_experts 8,
# one expert a rank): 4096 tokens x 4096 f32 a rank, 64 MiB
MOE_TOKENS = 4096
MOE_DMODEL = 4096
# the sequence-parallel attention cell at Ouro-2.6B's attention width
# (config.json of ByteDance/Ouro-2.6B: num_attention_heads =
# num_key_value_heads = 16, head_dim 128), 8 virtual ranks of 4096
# tokens: 32,768 of its 65,536 max_position_embeddings, f32, causal
ATTN_P = 8
ATTN_T = 4096
ATTN_H = 16
ATTN_D = 128
ATTN_SAMPLE = 256                  # rows a rank held against dense attention
# the JAX tests' bound for flash against dense attention: the streaming
# softmax orders its f32 sums otherwise
ATTN_TOL = dict(rtol=2e-4, atol=2e-5)
# K15/K16 against f64 attention at full width: at most this many times
# the plain f32 version's max error (one TF32 product errs ~1000x more)
ATTN_F64_FACTOR = 10.0
ATTN_SHARP = 4.0                   # q and k scale of the sharp-logit cases


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
        # the residency of the quant kernels and of the f32 sum
        # instances of K3-K8, K10 and K11: registers and spills an entry
        entry = None
        for ln in lines:
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1] if "'" in ln else ln
            elif entry and ("registers" in ln or "spill" in ln):
                kern = [k for k in REG_REPORT if k in entry]
                copy = re.search(r"(rma_copy_kernel|hbm_alltoallv_direct_"
                                 r"kernel)I(\w)E", entry)
                direct = re.search(r"(ring_(?:all_reduce|all_gather|reduce_"
                                   r"scatter)_direct_kernel)I("
                                   + "|".join(DIRECT_TYPES) + ")E", entry)
                if copy:
                    log(f"[build] {copy.group(1)}<"
                        f"{COPY_TYPES[copy.group(2)]}>: {ln.strip()}")
                elif "rma_acc_direct_kernelIfE" in entry:
                    log(f"[build] rma_acc_direct_kernel<float>: "
                        f"{ln.strip()}")
                elif direct:
                    log(f"[build] {direct.group(1)}<"
                        f"{DIRECT_TYPES[direct.group(2)]}>: {ln.strip()}")
                elif "slot_reduce_kernelIf" in entry:
                    log(f"[build] {_k1_inst(entry)}: {ln.strip()}")
                elif K9_INST.search(entry):
                    log(f"[build] {_k9_inst(entry)}: {ln.strip()}")
                elif "quant" in entry or (kern and ("IfLi0E" in entry
                                                    or "IjE" in entry)):
                    log(f"[build] {(kern or [entry[:60]])[0]}: "
                        f"{ln.strip()}")
    log(f"[build] built and loaded {', '.join(SOURCES)} in {dt:.2f} s")
    return dt


def _k1_inst(entry):
    """'slot_reduce_kernel<float, words, ByPtr>' and the like for a
    mangled float instance of K1."""
    words = "words" if "Lb1E" in entry else "elements"
    addr = "ByPtr" if "ByPtr" in entry else "Strided"
    return f"slot_reduce_kernel<float, {words}, {addr}>"


K9_INST = re.compile(r"quant_ring_all_reduce_kernelI(f|6__half)Li(\d)ELb(\d)E")


def _k9_inst(entry):
    """'quant_ring_all_reduce_kernel<f32, q8, false>' and the like for a
    mangled K9 instance (the last argument: true for the scratch row of
    a block of more than 128 values)."""
    mm = K9_INST.search(entry)
    return (f"quant_ring_all_reduce_kernel<"
            f"{'f32' if mm.group(1) == 'f' else 'f16'}, "
            f"{('q8', 'fp8')[int(mm.group(2))]}, "
            f"{('false', 'true')[int(mm.group(3))]}>")


FLASH_INST = re.compile(r"flash_kernelI(f|6__half|13__nv_bfloat16)Li(\d+)E")
FLASH_TYPES = {"f": "f32", "6__half": "f16", "13__nv_bfloat16": "bf16"}


def _flash_inst(line):
    """'f32/128' for a line naming flash_kernel<float, 128>, else None."""
    mm = FLASH_INST.search(line)
    return f"{FLASH_TYPES[mm.group(1)]}/{mm.group(2)}" if mm else None


def phase_flash_build(_build):
    """The flash kernel as built: ptxas's registers and spill bytes of
    each instance (dtype/head width) from the build log, and the
    tensor-core instructions (HMMA) in each instance's SASS, by
    cuobjdump. Raises if an instance has none: its products would not
    run on the tensor cores."""
    import shutil
    res, inst = {}, None
    for ln in _build.BUILD_LOGS.get("flash", "").splitlines():
        if "Compiling entry function" in ln:
            inst = _flash_inst(ln)
            if inst:
                res[inst] = {}
        elif inst and (mm := re.search(r"(\d+) bytes spill stores, (\d+) "
                                       r"bytes spill loads", ln)):
            res[inst]["spill_bytes"] = int(mm.group(1)) + int(mm.group(2))
        elif inst and (mm := re.search(r"Used (\d+) registers", ln)):
            res[inst]["registers"] = int(mm.group(1))
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(tool):
        log("[build] flash SASS: not measured (no cuobjdump)")
        return res
    sass = subprocess.run([tool, "--dump-sass",
                           str(_build.library_path("flash"))],
                          capture_output=True, text=True, timeout=600,
                          check=True).stdout
    inst, ops = None, set()
    for ln in sass.splitlines():
        if "Function :" in ln:
            inst = _flash_inst(ln)
            if inst:
                res.setdefault(inst, {})["hmma"] = 0
        elif inst and "HMMA" in ln:
            res[inst]["hmma"] += 1
            op = re.search(r"HMMA\.[\w.]+", ln)
            ops.add(op.group(0) if op else "HMMA")
    short = [i for i, r in res.items() if not r.get("hmma")]
    if short or not res:
        raise AssertionError(f"[build] flash: no HMMA in the SASS of "
                             f"{short or 'any instance'}")
    d128 = res.get("f32/128", {})
    log(f"[build] flash_kernel f32/128: {d128.get('registers')} registers, "
        f"{d128.get('spill_bytes')} bytes of spill stores and loads, "
        f"{d128['hmma']} HMMA ({', '.join(sorted(ops))}); all {len(res)} "
        f"instances: " + ", ".join(
            f"{i} {r.get('registers')}r/{r.get('spill_bytes')}s/"
            f"{r['hmma']}h" for i, r in res.items()))
    return res


def _data(torch, np, rng, shape, kind, dev):
    if kind == "f32int":
        a = rng.integers(-1000, 1000, size=shape).astype(np.float32)
    elif kind == "i32":
        a = rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int32)
    elif kind in ("i16", "i8", "u8", "u16", "u32"):
        dt = {"i16": np.int16, "i8": np.int8, "u8": np.uint8,
              "u16": np.uint16, "u32": np.uint32}[kind]
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
    if str(got.dtype) in UINT_VIEW:
        view = getattr(torch, UINT_VIEW[str(got.dtype)])
        got, want = got.cpu().view(view), want.cpu().view(view)
    err = (got.double() - want.double()).abs().max().item() \
        if got.numel() else 0.0
    if kind in BITWISE:
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
    # the other kernel dtypes, small (uint16/uint32: plain on the CPU)
    for kind in ("f16", "i16", "i8", "u8", "u16", "u32"):
        x = _data(torch, np, rng, (R, M_SMALL, 128), kind, dev)
        xp = x.cpu() if kind in ("u16", "u32") else x
        for mean in (False, True):
            _compare(torch, f"K1 planar {kind} mean={mean}",
                     hbm.fused_reduce_to_slot(x, mean=mean),
                     hbm.fused_reduce_to_slot_ref(xp, mean=mean), kind)
        xi = hbm.pack_interleaved(x.reshape(R, -1))
        _compare(torch, f"K2 {kind}", hbm.fused_allreduce(xi),
                 hbm.fused_allreduce_ref(hbm.pack_interleaved(
                     xp.reshape(R, -1))), kind)
        n_checks += 3
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


# K1's pointer form: sources a launch and their lengths (the last: 8 x 64
# MiB f32, the main path's)
K1_RANKS = (1, 2, 3, 8)
K1_SIZES = (1, 37, 127, 128, 100003, N)


def phase_k1_ptr_kernels(torch, np, hbm, dev):
    """K1's pointer form (the main path's: R separate tensors read in
    place by address) bitwise against its plain version (the ranks summed
    in rank order): the nine dtypes, sum and mean, R = 1, 2, 3 and 8, n
    = 1, 37, 127, 128, 100003 and 16 Mi, each source its own allocation,
    16-byte aligned (the word instance) and as a view at a 1-element
    offset (the element instance), ``hbm.PATHS`` read after every launch.
    uint16/uint32 plain versions run on the CPU. Returns the max abs
    error at 8 x 64 MiB f32 (sum)."""
    rng = np.random.default_rng(SEED + 50)
    n_checks, full = 0, 0.0
    for kind in K3_KINDS:
        for n in K1_SIZES:
            srcs = _shards(torch, np, rng, max(K1_RANKS), n + 1, kind, dev)
            for off, path in ((0, "ptrs_words"), (1, "ptrs_elements")):
                views = [s[off:off + n] for s in srcs]
                plain = [v.cpu() for v in views] \
                    if kind in ("u16", "u32") else views
                for rr in K1_RANKS:
                    for mean in (False, True):
                        before = dict(hbm.PATHS)
                        got = hbm.hbm_slot_allreduce(views[:rr], mean=mean)
                        torch.cuda.synchronize()
                        moved = {k: v - before[k] for k, v in
                                 hbm.PATHS.items() if v != before[k]}
                        if moved != {path: 1}:
                            raise AssertionError(
                                f"K1 pointer form {kind} n={n} offset={off}: "
                                f"paths moved {moved}, expected {path}")
                        err = _compare(
                            torch, f"K1 pointer form {kind} R={rr} n={n} "
                            f"offset={off} mean={mean}", got,
                            hbm.hbm_slot_allreduce_ref(plain[:rr], mean=mean),
                            "i32")
                        n_checks += 1
                        if kind == "f32" and n == N and rr == R and not mean \
                                and off == 0:
                            full = err
            del srcs, views, plain
    log(f"[kernels] {n_checks} K1 pointer-form checks passed, bitwise (9 "
        f"dtypes x sum/mean x R {K1_RANKS} x n {K1_SIZES} x aligned / "
        f"offset 1; 8 x 64 MiB f32 max abs err {full:.3g})")
    return {"K1": full}


def _shards(torch, np, rng, p, n, kind, dev):
    """p per-rank shards, each its own allocation (as ranks deposit)."""
    x = _data(torch, np, rng, (p, n), kind, dev)
    return [x[r].clone() for r in range(p)]


def phase_ring_kernels(torch, np, ici, ring, dev):
    """K3, K5, K6 and K7 against their plain versions (which replay the
    same ring schedule). K3 (the direct fold) bit for bit on all nine
    dtypes and four ops, one and two ring directions, ragged n (the
    scalar path) and n whose blocks and halves are whole 16-byte words
    (the vector path), shards at element offset 1, p = 2, 3, 5, 8 and
    64, 2 and 4 lines, NaN and signed zeros under max and min, and 8 x
    64 MiB f32 on both paths (n = N - 3 and shards at offset 1 take the
    scalar one); K5 bit for bit on f32, i32, i16, i8 and u8, shards
    aligned and at element offset 1, over 1 and 2 lines, up to 8 x 64
    MiB; K6 and K7 bit for bit at p = 2, 3, 5, 8 and 64, on every dtype
    class, on their vector and scalar paths. Returns the max abs error
    of the full-size f32 checks per kernel."""
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

    def check_bits(what, got, want, key=None, nan=False):
        """Bit for bit through a same-width integer view; ``nan``: every
        NaN taken as one pattern first (a NaN's payload is the card's
        arithmetic, not the fold order; where NaNs and signed zeros land
        is the fold order's)."""
        want = want.to(got.device)
        iv = {1: torch.int8, 2: torch.int16,
              4: torch.int32}[got.element_size()]
        gb, wb = got.view(iv), want.view(iv)
        if nan:
            gb = gb.masked_fill(got.isnan(), -1)
            wb = wb.masked_fill(want.isnan(), -1)
        check(what, gb, wb, "i32", key)

    def offset_shards(p, n, kind, off):
        x = _data(torch, np, rng, (p, n + off), kind, dev)
        return [x[r].clone()[off:off + n] for r in range(p)]

    def plain_side(xs, kind):
        return [x.cpu() for x in xs] if kind in ("u16", "u32") else xs

    def nan_zero_shards(p, n, kind):
        """Values from {-1, -0.0, +0.0, 1, NaN}."""
        pool = np.array([-1.0, -0.0, 0.0, 1.0, np.nan], np.float32)
        x = torch.from_numpy(pool[rng.integers(0, 5, size=(p, n))]).to(
            dev, getattr(torch, K3_FLOATS[kind]))
        return [x[r].clone() for r in range(p)]

    # K3: every dtype and op, both directions, on the vector path (blocks
    # of 32 or 64, halves of 16 or 32: whole words at every width), the
    # scalar path (a ragged n; a short last block; shards at offset 1)
    # and p up to the kernel's 64 ranks (eight of its load groups)
    ops = ("sum", "max", "min", "prod")
    for p, n, off in ((8, 8 * 32, 0), (8, 8 * 32, 1), (8, 37, 0),
                      (3, 10, 0), (2, 9, 0), (5, 5 * 64, 0),
                      (5, 5 * 64 - 3, 0), (64, 64 * 32, 0), (64, 1000, 0)):
        for kind in K3_KINDS:
            xs = offset_shards(p, n, kind, off)
            xp = plain_side(xs, kind)
            for op in ops:
                for bidir in (True, False):
                    check_bits(f"K3 p={p} n={n} off={off} {kind} {op} "
                               f"bidir={bidir}",
                               ici.hbm_ring_all_reduce(
                                   xs, op, bidirectional=bidir),
                               ici.hbm_ring_all_reduce_ref(
                                   xp, op, bidirectional=bidir))
    # K3 under max and min with NaNs and ties of -0.0 and +0.0
    for p, n in ((8, 8 * 32), (8, 37), (64, 64 * 32)):
        for kind in K3_FLOATS:
            xs = nan_zero_shards(p, n, kind)
            for op in ("max", "min"):
                for bidir in (True, False):
                    check_bits(f"K3 NaN/-0 p={p} n={n} {kind} {op} "
                               f"bidir={bidir}",
                               ici.hbm_ring_all_reduce(
                                   xs, op, bidirectional=bidir),
                               ici.hbm_ring_all_reduce_ref(
                                   xs, op, bidirectional=bidir), nan=True)
    # K3 over 2 and 4 lines on both paths (the per-axis allreduce of a
    # multi-axis mesh below DEV_TIER_AXES_MIN)
    for lines in (2, 4):
        for n in (1024, 1001):
            for kind in ("f32", "bf16", "i8", "u16"):
                xs = _shards(torch, np, rng, R, n, kind, dev)
                xp = plain_side(xs, kind)
                for op in ops:
                    for bidir in (True, False):
                        check_bits(f"K3 lines={lines} n={n} {kind} {op} "
                                   f"bidir={bidir}",
                                   ici.hbm_ring_all_reduce(
                                       xs, op, bidirectional=bidir,
                                       lines=lines),
                                   ici.hbm_ring_all_reduce_ref(
                                       xp, op, bidirectional=bidir,
                                       lines=lines))
    # K3 at the mesh path's 8 x 64 MiB f32, normal and integer-valued
    for kind in ("f32int", "f32"):
        xs = _shards(torch, np, rng, R, N, kind, dev)
        check_bits(f"K3 full {kind}", ici.hbm_ring_all_reduce(xs),
                   ici.hbm_ring_all_reduce_ref(xs),
                   "K3" if kind == "f32" else None)
        del xs
    # K3's scalar path at that size, over many grid-stride passes: a
    # ragged n (blocks of no whole words) and shards at element offset 1
    for n, off in ((N - 3, 0), (N, 1)):
        xs = offset_shards(R, n, "f32", off)
        for op in ("sum", "max"):
            check_bits(f"K3 full scalar n={n} off={off} {op}",
                       ici.hbm_ring_all_reduce(xs, op, bidirectional=True),
                       ici.hbm_ring_all_reduce_ref(xs, op,
                                                   bidirectional=True))
        del xs
    # K5 (the direct gather; chunk, depth and direction shape nothing on
    # the card): f32, i32 and the narrow widths, shards of whole 16-byte
    # words and not, then shards at element offset 1 (the element path)
    # over 1 and 2 lines, then 8 x 64 MiB over 1 and 2 lines
    for p, m, cb in ((8, 13, 16), (3, 5, 16), (8, 100003, 4096),
                     (8, AG_MESH, None)):
        for kind in ("i32", "f32", "i8", "u8", "i16"):
            xs = _shards(torch, np, rng, p, m, kind, dev)
            for depth in ((2, 3, 4) if m == 100003 else (2,)):
                for bidir in (True, False):
                    check(f"K5 p={p} m={m} {kind} depth={depth} "
                          f"bidir={bidir}",
                          ici.hbm_ring_all_gather(
                              xs, chunk_bytes=cb, depth=depth,
                              bidirectional=bidir),
                          ici.hbm_ring_all_gather_ref(
                              xs, bidirectional=bidir), "i32")  # bitwise
    for m in (AG_MESH, 1001):
        for lines in (1, 2):
            for kind in ("f32", "u8", "i16"):
                x = _data(torch, np, rng, (R, m + 1), kind, dev)
                xs = [x[r].clone()[1:] for r in range(R)]
                check(f"K5 m={m} lines={lines} {kind} at offset 1",
                      ici.hbm_ring_all_gather(xs, lines=lines),
                      ici.hbm_ring_all_gather_ref(xs, lines=lines), "i32")
    xs = _shards(torch, np, rng, R, N, "f32", dev)
    check("K5 full f32", ici.hbm_ring_all_gather(xs),
          ici.hbm_ring_all_gather_ref(xs), "i32", "K5")
    check("K5 full f32 over 2 lines", ici.hbm_ring_all_gather(xs, lines=2),
          ici.hbm_ring_all_gather_ref(xs, lines=2), "i32")
    del xs
    # K6 (n % p == 0, at most 4 MiB) and K7 (output at most 4 MiB), bit
    # for bit: p up to the kernels' 64 ranks (two of K6's load groups);
    # blocks (K6) and shards (K7) of whole 16-byte words and of an odd
    # length; shards that are views at element offset 1 (no shard
    # aligned), so the scalar path runs too; then the mesh path's
    # 64 KiB and the 4 MiB limit. uint16/uint32 plain versions on the CPU
    kinds6 = ("f32", "f32int", "i32", "bf16", "f16", "i16", "i8", "u8",
              "u16", "u32")
    kinds7 = ("f32", "i32", "bf16", "f16", "i16", "i8", "u8", "u16", "u32")
    for p in (2, 3, 5, 8, 64):
        for blk in (32, 5):
            for off in (0, 1):
                for kind in kinds6:
                    xs = offset_shards(p, p * blk, kind, off)
                    check_bits(f"K6 p={p} blk={blk} off={off} {kind}",
                               ring.ring_all_reduce(xs),
                               ring.ring_all_reduce_ref(plain_side(xs, kind)))
                for kind in kinds7:
                    xs = offset_shards(p, blk, kind, off)
                    check_bits(f"K7 p={p} m={blk} off={off} {kind}",
                               ring.ring_all_gather(xs),
                               ring.ring_all_gather_ref(plain_side(xs, kind)))
    for n in (SMALL_MESH, RESIDENT_FULL):
        for kind in kinds6:
            xs = _shards(torch, np, rng, R, n, kind, dev)
            check_bits(f"K6 p={R} n={n} {kind}", ring.ring_all_reduce(xs),
                       ring.ring_all_reduce_ref(plain_side(xs, kind)),
                       "K6" if n == RESIDENT_FULL and kind == "f32" else None)
    for m in (SMALL_MESH, RESIDENT_FULL // R):
        for kind in kinds7:
            xs = _shards(torch, np, rng, R, m, kind, dev)
            check_bits(f"K7 p={R} m={m} {kind}", ring.ring_all_gather(xs),
                       ring.ring_all_gather_ref(plain_side(xs, kind)),
                       "K7" if m == RESIDENT_FULL // R and kind == "f32"
                       else None)
    del xs
    log(f"[kernels] {n_checks} ring kernel-vs-plain checks passed "
        f"(full-size f32 max abs err: "
        + ", ".join(f"{k} {v:.3g}" for k, v in full_err.items()) + ")")
    return full_err


def phase_rs_kernels(torch, np, ici, ring, dev):
    """K4 and K8, and K3/K5 over several lines, against their plain
    versions, bitwise: K4 on the nine dtypes of K3 with the four ops,
    small and ragged sizes (n % p != 0: the padded tail of the last
    block holds the op's identity; n = 1: every block but the first is
    padding; whole-word blocks and halves on the word path), NaN and
    signed zeros under max and min, the TPU schedule's depth 2/3/4 and
    chunk sizes (which shape nothing), one and two ring directions,
    lines 1, 2 and 4, the (2, 4) mesh's RS-x phase and 8 x 64 MiB f32;
    K3 and K5 with lines 2 and 4; every K4/K5 phase of the (2, 4) and
    (4, 2) programs and every K3/K5/K6/K7 ring of the fold path at the
    shapes the paths give them; K8 on f32, bf16, i32 and u8, an n that
    is no multiple of 16 bytes, src == dst, 8 x 64 MiB. uint16/uint32
    plain versions run on the CPU. Returns the max abs error of the
    full-size f32 checks (K4, K8)."""
    rng = np.random.default_rng(SEED + 500)
    n_checks = 0
    full_err = {}

    def check(what, got, want, key=None):
        nonlocal n_checks
        torch.cuda.synchronize()
        ring.check_errors()
        err = _compare(torch, what, got, want, "i32")      # bitwise
        n_checks += 1
        if key:
            full_err[key] = err

    def plain_side(xs, kind):
        return [x.cpu() for x in xs] if kind in ("u16", "u32") else xs

    # K4: small and ragged, the nine dtypes and the four ops (f32 normal
    # data: the fold order is the plain version's, so bitwise too)
    for p, n, cb in ((8, 64, 64), (8, 37, 16), (3, 10, 16), (2, 9, 16),
                     (8, 1000, 64), (4, 1025, 256), (8, 4096, None),
                     (8, 1, None), (5, 5 * 64 - 3, None)):
        for kind in K3_KINDS:
            xs = _shards(torch, np, rng, p, n, kind, dev)
            xp = plain_side(xs, kind)
            for op in ("sum", "max", "min", "prod"):
                for bidir in (True, False):
                    check(f"K4 p={p} n={n} {kind} {op} bidir={bidir}",
                          ici.hbm_ring_reduce_scatter(
                              xs, op, chunk_bytes=cb, bidirectional=bidir),
                          ici.hbm_ring_reduce_scatter_ref(
                              xp, op, bidirectional=bidir))
    # K4 under max and min with NaNs and ties of -0.0 and +0.0 (NaNs
    # compared as one pattern: where they land is the fold order's,
    # their payload the card's arithmetic)
    pool = np.array([-1.0, -0.0, 0.0, 1.0, np.nan], np.float32)
    for p, n in ((8, 8 * 32), (8, 37)):
        for kind, tname in K3_FLOATS.items():
            x = torch.from_numpy(pool[rng.integers(0, 5, size=(p, n))]).to(
                dev, getattr(torch, tname))
            xs = [x[r].clone() for r in range(p)]
            iv = {1: torch.int8, 2: torch.int16,
                  4: torch.int32}[xs[0].element_size()]
            for op in ("max", "min"):
                for bidir in (True, False):
                    got = ici.hbm_ring_reduce_scatter(xs, op,
                                                      bidirectional=bidir)
                    want = ici.hbm_ring_reduce_scatter_ref(
                        xs, op, bidirectional=bidir)
                    check(f"K4 NaN/-0 p={p} n={n} {kind} {op} "
                          f"bidir={bidir}",
                          got.view(iv).masked_fill(got.isnan(), -1),
                          want.view(iv).masked_fill(want.isnan(), -1))
    # K4 depth / direction / lines at a size of many chunks
    for n in (100003, 8 * 3584):
        for kind in ("f32", "i32"):
            xs = _shards(torch, np, rng, R, n, kind, dev)
            for lines in (1, 2, 4):
                for depth in ((2, 3, 4) if lines == 1 else (2,)):
                    for bidir in (True, False):
                        check(f"K4 n={n} {kind} lines={lines} "
                              f"depth={depth} bidir={bidir}",
                              ici.hbm_ring_reduce_scatter(
                                  xs, chunk_bytes=4096, depth=depth,
                                  bidirectional=bidir, lines=lines),
                              ici.hbm_ring_reduce_scatter_ref(
                                  xs, bidirectional=bidir, lines=lines))
    # K3 and K5 over lines
    for lines in (2, 4):
        for kind in ("f32", "i32"):
            xs = _shards(torch, np, rng, R, 100003, kind, dev)
            for op in ("sum", "max"):
                check(f"K3 lines={lines} {kind} {op}",
                      ici.hbm_ring_all_reduce(xs, op, chunk_bytes=4096,
                                              lines=lines),
                      ici.hbm_ring_all_reduce_ref(xs, op, lines=lines))
        for kind in ("f32", "i8"):
            for m in (13, 100003):
                xs = _shards(torch, np, rng, R, m, kind, dev)
                check(f"K5 lines={lines} m={m} {kind}",
                      ici.hbm_ring_all_gather(xs, chunk_bytes=4096,
                                              lines=lines),
                      ici.hbm_ring_all_gather_ref(xs, lines=lines))
    # full size: 1-D, and the (2, 4) mesh's RS-x phase (4 lines of 2)
    xs = _shards(torch, np, rng, R, N, "f32", dev)
    check("K4 8 x 64 MiB f32", ici.hbm_ring_reduce_scatter(xs),
          ici.hbm_ring_reduce_scatter_ref(xs), "K4")
    rsx = [xs[i] for i in (0, 4, 1, 5, 2, 6, 3, 7)]
    check("K4 8 x 64 MiB f32, (2, 4) RS-x",
          ici.hbm_ring_reduce_scatter(rsx, lines=4),
          ici.hbm_ring_reduce_scatter_ref(rsx, lines=4))
    del rsx

    def mesh_phases(what, axes, y, op=None):
        """Every phase of a multi-axis program at the path's shapes and
        line orders, each fed the kernel output of the phase before:
        reduce-scatter down the axes (K4) when ``op`` is set, then
        all-gather back up (K5)."""
        steps = [(k, "K4", ici.hbm_ring_reduce_scatter,
                  ici.hbm_ring_reduce_scatter_ref, dict(op=op))
                 for k in (range(len(axes)) if op else ())]
        steps += [(k, "K5", ici.hbm_ring_all_gather,
                   ici.hbm_ring_all_gather_ref, {})
                  for k in reversed(range(len(axes)))]
        for k, name, kern, plain, kw in steps:
            got = ici._axis_phase(y, axes, k, lambda sh, lines: kern(
                sh, lines=lines, **kw))
            want = ici._axis_phase(y, axes, k, lambda sh, lines: plain(
                sh, lines=lines, **kw))
            check(f"{name} {what} phase {axes[k][0]}: "
                  f"{len(y) // axes[k][1]} lines of {axes[k][1]}, "
                  f"{y[0].numel()} elements a rank",
                  torch.stack(got), torch.stack(want))
            del want
            y = got
    # the multi-axis path's phases: the 64 MiB allreduce (and
    # reduce_scatter_block) on (2, 4) and (4, 2), the 64 MiB max, the
    # 1 MiB allgather
    xy = (("x", 2), ("y", 4))
    mesh_phases("(2, 4) allreduce", xy, xs, "sum")
    mesh_phases("(2, 4) max", xy, xs, "max")
    mesh_phases("(4, 2) allreduce", (("x", 4), ("y", 2)), xs, "sum")
    mesh_phases("(2, 4) allgather", xy,
                _shards(torch, np, rng, R, AG_MESH, "f32", dev))
    # the fold path's rings over the chip shards: 4 chips (K3 sum and max
    # at 64 MiB, K6 at 64 KiB, K7 and K5 on 2 ranks' gathered slots),
    # 2 chips (K3)
    for p in (4, 2):
        for op in (("sum", "max") if p == 4 else ("sum",)):
            check(f"K3 fold p={p} 64 MiB f32 {op}",
                  ici.hbm_ring_all_reduce(xs[:p], op),
                  ici.hbm_ring_all_reduce_ref(xs[:p], op))
    sm = _shards(torch, np, rng, 4, 2 * SMALL_MESH, "f32", dev)
    check("K6 fold p=4 64 KiB f32", ring.ring_all_reduce(
        [x[:SMALL_MESH] for x in sm]),
        ring.ring_all_reduce_ref([x[:SMALL_MESH] for x in sm]))
    check("K7 fold p=4 128 KiB f32", ring.ring_all_gather(sm),
          ring.ring_all_gather_ref(sm))
    ag = _shards(torch, np, rng, 4, 2 * AG_MESH, "f32", dev)
    check("K5 fold p=4 2 MiB f32", ici.hbm_ring_all_gather(ag),
          ici.hbm_ring_all_gather_ref(ag))
    del sm, ag
    # K8
    for p, n in ((8, 64), (8, 37), (3, 1000), (8, 100003)):
        for kind in ("f32", "bf16", "i32", "u8"):
            xs = _shards(torch, np, rng, p, n, kind, dev)
            for src, dst in ((p - 1, 0), (1, p - 2), (1, 1)):
                got = ici.remote_sendrecv(xs, src, dst)
                check(f"K8 p={p} n={n} {kind} {src}<->{dst}", got,
                      ici.remote_sendrecv_ref(xs, src, dst))
    # K8's cut: shards as views at 1, 2 and 3 elements with n of whole
    # words plus 0..3 (bulk rows with a head and a tail, where the row
    # agrees with its shard mod 16 bytes; element rows where it does not),
    # n just below and above one tile; ici.PATHS against k8_plan's count
    tile = ici.kernel_param("k8_tile_bytes", 32768)
    cut_rows = {"head_or_tail": 0, "element": 0}

    def k8_check(what, xs, src, dst):
        before = dict(ici.PATHS)
        got = ici.remote_sendrecv(xs, src, dst)
        n, es = xs[0].numel(), xs[0].element_size()
        part = ici._partners(len(xs), src, dst)
        _, _, cuts = ici.k8_plan(
            [xs[j].data_ptr() for j in part],
            [got.data_ptr() + r * n * es for r in range(len(xs))],
            n * es, tile)
        bulk = sum(c is not None for c in cuts)
        moved = {k: v - before[k] for k, v in ici.PATHS.items()}
        if moved != {"sendrecv_bulk_rows": bulk,
                     "sendrecv_element_rows": len(xs) - bulk}:
            raise AssertionError(f"{what}: rows {moved}, k8_plan {cuts}")
        cut_rows["element"] += len(xs) - bulk
        cut_rows["head_or_tail"] += sum(
            c is not None and c[1] < n * es for c in cuts)
        check(what, got, ici.remote_sendrecv_ref(xs, src, dst))

    for kind, es in (("f32", 4), ("bf16", 2), ("u8", 1)):
        v = 16 // es
        for off in (1, 2, 3):
            for n in (v * 4096 + off, v * 4096 + off + 2, tile // es + off):
                base = _shards(torch, np, rng, R, n + off, kind, dev)
                k8_check(f"K8 {kind} n={n} shards at offset {off}",
                         [b[off:] for b in base], 1, R - 2)
        for nb in (tile - 16, tile - es, tile, tile + es, tile + 16):
            k8_check(f"K8 {kind} {nb} bytes (tile {tile})", _shards(
                torch, np, rng, R, nb // es, kind, dev), 0, R - 1)
    if not cut_rows["head_or_tail"] or not cut_rows["element"]:
        raise AssertionError(f"K8's cut checks ran no head/tail or no "
                             f"element row: {cut_rows}")
    xs = _shards(torch, np, rng, R, N, "f32", dev)
    k8_check("K8 8 x 64 MiB f32", xs, 2, 5)
    full_err["K8"] = _compare(torch, "K8 8 x 64 MiB f32",
                              ici.remote_sendrecv(xs, 2, 5),
                              ici.remote_sendrecv_ref(xs, 2, 5), "i32")
    del xs
    log(f"[kernels] {n_checks} K4/K8/lines kernel-vs-plain checks passed, "
        f"bitwise; K8's cut: {cut_rows} rows with a head or tail / element "
        f"by element (full-size f32 max abs err: "
        + ", ".join(f"{k} {v:.3g}" for k, v in full_err.items()) + ")")
    return full_err


def _moe_counts(moe, shape, tokens=None, dmodel=None):
    """The MoE bench's element count matrix: routing() in tokens, times
    the width (default: the full width)."""
    tokens, dmodel = tokens or MOE_TOKENS, dmodel or MOE_DMODEL
    return [[c * dmodel for c in row] for row in moe.routing(R, tokens,
                                                             shape)]


def _sparse_counts():
    """Zero-count pairs, a row of zeros (rank 6 sends nothing but
    receives), and steps 2 and 4 empty on every rank."""
    c = [[0] * R for _ in range(R)]
    for r, j, n in ((0, 1, 37), (1, 2, 5), (2, 3, 1), (3, 6, 4099),
                    (5, 0, 3), (7, 6, 64), (4, 4, 11)):
        c[r][j] = n
    return c


def phase_a2a_kernels(torch, np, a2a, ring, moe, dev):
    """K10 and K11 against their plain versions, bitwise: K10 on f32,
    bf16, i32 and u8, p = 8 (and 3, 2), depth 2/3/4, one and two lanes,
    a ragged block, 64 MiB a rank; K11 (the direct copy by tile table) on
    every element width its C entry instantiates (f32, bf16, f16, i32,
    i8, u8, u16), the bench's routing matrices at p = 8, 3 and 2 (small,
    and at full width at p = 8), the sparse matrix, payloads that are
    views at element offset 1 (the element path), explicit spread
    displacements with ``out_len`` (zeroed outputs), under the four
    chunk settings of the TPU schedule (which shape nothing on the
    card). Returns the max abs error of the full-size f32 checks."""
    rng = np.random.default_rng(SEED + 400)
    n_checks = 0
    full_err = {}

    def check(what, got, want, kind, key=None):
        nonlocal n_checks
        torch.cuda.synchronize()
        ring.check_errors()
        if isinstance(got, list):
            if len(got) != len(want):
                raise AssertionError(f"{what}: {len(got)} outputs")
            err = max(_compare(torch, what, g, w, "i32")
                      for g, w in zip(got, want))
        else:
            err = _compare(torch, what, got, want, "i32")  # bitwise
        n_checks += 1
        if key:
            full_err[key] = err
        return err

    kinds = ("f32", "bf16", "i32", "u8")
    for p, c, cb in ((8, 13, 16), (8, 1000, 256), (8, 4096, None),
                     (3, 5, 8), (2, 7, 8)):
        for kind in kinds:
            xs = _shards(torch, np, rng, p, p * c, kind, dev)
            for depth in ((2, 3, 4) if c == 1000 else (2,)):
                for bidir in (True, False):
                    check(f"K10 p={p} c={c} {kind} depth={depth} "
                          f"bidir={bidir}",
                          a2a.hbm_alltoall(xs, chunk_bytes=cb, depth=depth,
                                           bidirectional=bidir),
                          a2a.hbm_alltoall_ref(xs), kind)
    xs = _shards(torch, np, rng, R, N, "f32", dev)
    check("K10 64 MiB f32", a2a.hbm_alltoall(xs), a2a.hbm_alltoall_ref(xs),
          "f32", "K10")
    del xs
    mats = {s: _moe_counts(moe, s, 64, 3) for s in ("uniform", "skew",
                                                     "hot")}
    mats["sparse"] = _sparse_counts()
    # uint16: the plain version on the CPU
    kinds11 = kinds + ("f16", "i8", "u16")

    def plain_side(xs, kind):
        return [x.cpu() for x in xs] if kind == "u16" else xs

    def payloads(counts, kind, off=0):
        """Each rank's payload, its own allocation, as a view at element
        ``off`` (1: no payload 16-byte aligned)."""
        return [_data(torch, np, rng, (sum(row) + off,), kind, dev)[off:]
                for row in counts]

    for name, counts in mats.items():
        for kind in kinds11:
            xs = payloads(counts, kind)
            for cb, depth, bidir in ((16, 2, True), (64, 3, False),
                                     (4096, 4, True), (None, 2, False)):
                check(f"K11 {name} {kind} chunk={cb} depth={depth} "
                      f"bidir={bidir}",
                      a2a.hbm_alltoallv(xs, counts, chunk_bytes=cb,
                                        depth=depth, bidirectional=bidir),
                      a2a.hbm_alltoallv_ref(plain_side(xs, kind), counts),
                      kind)
            xs = payloads(counts, kind, off=1)
            check(f"K11 {name} {kind} payloads at offset 1",
                  a2a.hbm_alltoallv(xs, counts),
                  a2a.hbm_alltoallv_ref(plain_side(xs, kind), counts), kind)
    # explicit displacements: every send and receive 4 elements apart
    # from the next, outputs longer than the last receive (gaps zeroed)
    for name in ("hot", "sparse"):
        counts = mats[name]
        sd = [[sum(row[:j]) + 4 * j for j in range(R)] for row in counts]
        rd = [[sum(counts[i][j] for i in range(r)) + 4 * r
               for r in range(R)] for j in range(R)]
        ext = max(rd[j][r] + counts[r][j] for j in range(R)
                  for r in range(R))
        for kind in ("f32", "i8", "bf16"):
            xs = [_data(torch, np, rng, (sum(row) + 4 * R,), kind, dev)
                  for row in counts]
            kw = dict(sdispls=sd, rdispls=rd, out_len=ext + 16)
            check(f"K11 {name} {kind} spread displacements, out_len",
                  a2a.hbm_alltoallv(xs, counts, **kw),
                  a2a.hbm_alltoallv_ref(xs, counts, **kw), kind)
    # p = 3 and 2
    for p in (3, 2):
        for shape in ("uniform", "skew", "hot"):
            counts = [[c * 5 for c in row]
                      for row in moe.routing(p, 48, shape)]
            for kind in ("f32", "i8", "u16"):
                xs = payloads(counts, kind)
                check(f"K11 p={p} {shape} {kind}",
                      a2a.hbm_alltoallv(xs, counts),
                      a2a.hbm_alltoallv_ref(plain_side(xs, kind), counts),
                      kind)
    for shape in ("hot", "skew", "uniform"):
        counts = _moe_counts(moe, shape)
        xs = [_data(torch, np, rng, (sum(counts[r]),), "f32", dev)
              for r in range(R)]
        check(f"K11 {shape} 4096 x 4096 f32", a2a.hbm_alltoallv(xs, counts),
              a2a.hbm_alltoallv_ref(xs, counts), "f32",
              "K11" if shape == "hot" else None)
        del xs
    log(f"[kernels] {n_checks} alltoall kernel-vs-plain checks passed, "
        f"bitwise (full-size f32 max abs err: K10 {full_err['K10']:.3g}, "
        f"K11 {full_err['K11']:.3g})")
    return full_err


def phase_rma_kernels(torch, np, rma, ring, dev):
    """K12, K13, K14 and K17 against their plain versions, bitwise, the
    whole window compared (rows other than the target's must not move;
    a get must leave the window as it was): RMA_KINDS, counts below one
    16-byte vector, misaligned disp, partial tail chunks, chunk_bytes 16
    and the default, depth 2/3/4, origin == target at p = 2 and 8, and
    N - 7 elements at disp 5 of a 64 MiB-a-rank f32 window; then the
    direct copy's and the direct fold's own cases (``_copy_checks``,
    ``_acc_checks``). Returns the max abs error of the full-size
    checks."""
    rng = np.random.default_rng(SEED + 900)
    n_checks = 0
    full_err = {}

    def run(op, p, length, n, disp, origin, target, kind, cb, depth,
            key=None, win=None, src=None):
        nonlocal n_checks
        if win is None:
            win = _data(torch, np, rng, (p, length), kind, dev)
            src = _data(torch, np, rng, (n,), kind, dev)
        # uint16/uint32: the plain version on the CPU
        cpu = kind in ("u16", "u32")
        want = win.cpu() if cpu else win.clone()
        src_p = src.cpu() if cpu else src
        got = win.clone()
        what = (f"{op} p={p} N={length} n={n} disp={disp} {origin}->"
                f"{target} {kind} chunk={cb} depth={depth}")
        if op == "rma_get":
            out = rma.rma_get(got, n, origin, target, disp, chunk_bytes=cb,
                              depth=depth)
            ref = rma.rma_get_ref(want, n, origin, target, disp)
        elif op == "direct_put":
            rma.direct_put(src, got, origin, target, disp)
            rma.rma_put_ref(src_p, want, origin, target, disp)
        else:
            getattr(rma, op)(src, got, origin, target, disp,
                             chunk_bytes=cb, depth=depth)
            getattr(rma, op + "_ref")(src_p, want, origin, target, disp)
        torch.cuda.synchronize()
        ring.check_errors()
        err = _compare(torch, what, got, want, "i32")      # bitwise
        if op == "rma_get":
            err = _compare(torch, what + " value", out, ref, "i32")
        n_checks += 1
        if key:
            full_err[key] = err

    ops = ("rma_put", "rma_get", "rma_accumulate", "direct_put")
    shapes = ((8, 64, 3, 5, 0, 7, 16, 2),       # below one vector
              (8, 64, 21, 3, 0, 7, 16, 3),      # tail chunk, misaligned
              (8, 64, 32, 0, 6, 1, 16, 4),      # whole chunks, aligned
              (8, 1000, 777, 13, 2, 5, None, 2),  # the default chunk
              (4, 4096, 4000, 96, 3, 0, 256, 3),  # many chunks
              (2, 64, 21, 3, 1, 1, 16, 2),      # origin == target, p = 2
              (8, 300, 250, 7, 5, 5, 64, 4))    # origin == target, p = 8
    for op in ops:
        for kind in RMA_KINDS:
            for p, length, n, disp, o, t, cb, depth in shapes:
                run(op, p, length, n, disp, o, t, kind, cb, depth)
    gen = torch.Generator(device=dev).manual_seed(SEED + 950)
    win = torch.randn(R, N, generator=gen, device=dev)
    src = torch.randn(N - 7, generator=gen, device=dev)
    for op, key in zip(ops, ("K12", "K13", "K14", "K17")):
        run(op, R, N, N - 7, 5, 0, R - 1, "f32", None, None, key, win, src)
    del win, src
    n_checks += _copy_checks(torch, np, rma, ring, dev)
    n_checks += _acc_checks(torch, np, rma, ring, dev)
    log(f"[kernels] {n_checks} RMA kernel-vs-plain checks passed, bitwise "
        f"(64 MiB-a-rank max abs err: "
        + ", ".join(f"{k} {v:.3g}" for k, v in full_err.items()) + ")")
    return full_err


COPY_KINDS = (("f32", 4), ("bf16", 2), ("i8", 1))


def _copy_checks(torch, np, rma, ring, dev):
    """The direct copy of K12, K13 and K17, bitwise, the whole window
    compared, on f32, bf16 and i8: every disp residue mod 16 bytes, into
    row 1 of a window whose rows are not 16-byte multiples (so the row
    itself starts misaligned), a put source at offset 0 and 1 element of
    a larger tensor, n at 1, the vector width V - 1, V, V + 1 and 3V + 5,
    and at one grid-stride pass - 1, + 0, + 1 and + 2V (disps 0, 1 and
    V - 1);
    then the overlap repair: K12, K14 and K17 with a source that is a
    view of the window, before the target range, after it, and the range
    itself, against the plain versions on a cloned source. Returns the
    number of checks."""
    rng = np.random.default_rng(SEED + 975)
    checks = 0

    def check(what, got, want):
        nonlocal checks
        torch.cuda.synchronize()
        ring.check_errors()
        _compare(torch, what, got, want, "i32")
        checks += 1

    for kind, esize in COPY_KINDS:
        v = 16 // esize
        one_pass = rma.copy_pass(dev, esize)
        cases = [(n, d) for n in (1, v - 1, v, v + 1, 3 * v + 5)
                 for d in range(v)]
        cases += [(n, d) for n in (one_pass - 1, one_pass, one_pass + 1,
                                   one_pass + 2 * v)
                  for d in (0, 1, v - 1)]
        length = one_pass + 3 * v + 3      # rows not 16-byte multiples
        base = _data(torch, np, rng, (2, length), kind, dev)
        big = _data(torch, np, rng, (one_pass + 2 * v + 1,), kind, dev)
        for n, d in cases:
            for off in (0, 1):
                src = big[off:off + n]
                want = base.clone()
                rma.rma_put_ref(src, want, 0, 1, d)
                for key, put in (("K12", rma.rma_put),
                                 ("K17", rma.direct_put)):
                    got = base.clone()
                    put(src, got, 0, 1, d)
                    check(f"{key} {kind} n={n} disp={d} src+{off}", got,
                          want)
            got = base.clone()
            out = rma.rma_get(got, n, 0, 1, d)
            check(f"K13 {kind} n={n} disp={d}", out,
                  rma.rma_get_ref(base, n, 0, 1, d))
            check(f"K13 {kind} n={n} disp={d} window", got, base)
        del base, big
    # the overlap repair: sources that are views of the target range's row
    base = _data(torch, np, rng, (2, 4096 + 64), "i32", dev)
    n, d = 4096, 32
    for op, ref in (("rma_put", rma.rma_put_ref),
                    ("rma_accumulate", rma.rma_accumulate_ref),
                    ("direct_put", rma.rma_put_ref)):
        for shift in (-29, -1, 0, 1, 29):
            got, want = base.clone(), base.clone()
            getattr(rma, op)(got[1, d + shift:d + shift + n], got, 0, 1, d)
            ref(want[1, d + shift:d + shift + n].clone(), want, 0, 1, d)
            check(f"{op} overlap {shift:+d}", got, want)
    return checks


def _acc_checks(torch, np, rma, ring, dev):
    """The direct fold of K14, bitwise, the whole window compared, on
    every kind of RMA_KINDS: every disp residue mod 16 bytes (each head
    length) into row 1 of a window whose rows are not 16-byte multiples,
    a source at offset 0 and 1 element of a larger tensor (misaligned
    against the destination), n at 1, V - 1, V, V + 1 and 3V + 5, and at
    one grid-stride pass - 1, + 0 and + 1 (disps 0, 1 and V - 1, the pass
    read from rma.accumulate_pass); then the exact alias (the target
    range itself, which must double) and a source one element off it
    (copied first), against the plain version on a cloned source.
    uint16/uint32 plain versions run on the CPU. Returns the number of
    checks."""
    rng = np.random.default_rng(SEED + 985)
    checks = 0

    def check(what, got, want):
        nonlocal checks
        torch.cuda.synchronize()
        ring.check_errors()
        _compare(torch, what, got, want, "i32")
        checks += 1

    for kind in RMA_KINDS:
        cpu = kind in ("u16", "u32")
        dt = _data(torch, np, rng, (1,), kind, dev).dtype
        v = 16 // dt.itemsize
        one_pass = rma.accumulate_pass(dev, dt)
        small = [(n, d) for n in (1, v - 1, v, v + 1, 3 * v + 5)
                 for d in range(v)]
        big = [(n, d) for n in (one_pass - 1, one_pass, one_pass + 1)
               for d in (0, 1, v - 1)]
        for cases, length in ((small, 7 * v + 3), (big, one_pass + 3 * v + 3)):
            base = _data(torch, np, rng, (2, length), kind, dev)
            srcs = _data(torch, np, rng, (length,), kind, dev)
            for n, d in cases:
                for off in (0, 1):
                    src = srcs[off:off + n]
                    got = base.clone()
                    want = base.cpu() if cpu else base.clone()
                    rma.rma_accumulate(src, got, 0, 1, d)
                    rma.rma_accumulate_ref(src.cpu() if cpu else src, want,
                                           0, 1, d)
                    check(f"K14 {kind} n={n} disp={d} src+{off}", got, want)
            del base, srcs
        base = _data(torch, np, rng, (2, 4096 + 64), kind, dev)
        n, d = 4096, 32
        for shift in (0, 1):
            got = base.clone()
            want = base.cpu() if cpu else base.clone()
            rma.rma_accumulate(got[1, d + shift:d + shift + n], got, 0, 1, d)
            rma.rma_accumulate_ref(want[1, d + shift:d + shift + n].clone(),
                                   want, 0, 1, d)
            check(f"K14 {kind} {'alias' if shift == 0 else 'overlap +1'}",
                  got, want)
    return checks


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
        # K1 reads the deposits in place: a send buffer written as soon
        # as its call returns must leave that call's result unchanged
        mine = me.clone()
        reused = comm.allreduce(mine)
        mine.fill_(-1.0)
        stream.synchronize()
        return outs, (lat, lat_small[n_warm:]), (mx, red, b, ag, a2a, rsb,
                                                 reused)

    hbm.reset_counts()
    t0 = time.perf_counter()
    res = mvt.run_ranks(R, app)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    slice_launches = dict(hbm.LAUNCHES)
    slice_paths = dict(hbm.PATHS)
    # + 4 KiB, reduce, rsb, the reused buffer's
    n_sum = n_check + 2 * (n_warm + n_timed) + 3
    if slice_launches["fused_reduce_to_slot"] != n_sum:
        raise AssertionError(f"K1 launched {slice_launches} times in the "
                             f"slice; expected {n_sum} (one per sum "
                             f"collective)")
    # every sum over device deposits reads them in place; the numpy
    # reduce's host deposits are staged once (the strided form)
    want_paths = dict.fromkeys(hbm.PATHS, 0)
    want_paths.update(ptrs_words=n_sum - 1, strided_words=1)
    if slice_paths != want_paths:
        raise AssertionError(f"K1 paths {slice_paths}, expected {want_paths}")
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
        mx, red, b, ag, a2a, rsb, reused = res[r][2]
        if not torch.equal(reused, res[r][0][0]):
            raise AssertionError("allreduce: a send buffer written after "
                                 "the call changed its result")
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
        f"in {wall:.2f} s; results checked (max abs err {err:.3g}; a "
        f"send buffer written after its call left the result unchanged); "
        f"K1 launches {slice_launches['fused_reduce_to_slot']}, paths "
        f"{ {k: v for k, v in slice_paths.items() if v} } (no staging "
        f"stack on the sum path)")
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
                     "quant_ring_all_reduce": 0,
                     "hbm_ring_reduce_scatter": 0, "remote_sendrecv": 0,
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


def _ar_lat(comm, torch, me, n_warm, n_timed):
    """Host-clock latency of ``n_timed`` allreduces of ``me`` after
    ``n_warm``, each ended by a stream synchronize."""
    stream = torch.cuda.current_stream()
    for _ in range(n_warm):
        comm.allreduce(me)
    lat = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        comm.allreduce(me)
        stream.synchronize()
        lat.append(time.perf_counter() - t0)
    return lat


def _zero(*mods):
    for m in mods:
        m.reset_counts()


def _launches(*mods):
    out = {}
    for m in mods:
        out.update(m.LAUNCHES)
    return out


def _want(mods, **nonzero):
    """Every kernel of ``mods`` at 0 launches but those named."""
    want = dict.fromkeys(_launches(*mods), 0)
    want.update(nonzero)
    return want


def _check_launches(what, mods, want):
    got = _launches(*mods)
    if got != want:
        raise AssertionError(f"[{what}] launches {got}, expected {want}")
    return got


def _check_pvars(mpit, what, before, want):
    delta = {k: mpit.pvar(k).read() - before[k] for k in want}
    if delta != want:
        raise AssertionError(f"[{what}] pvars moved by {delta}, expected "
                             f"{want}")
    return delta


COLL_PVARS = ("dev_coll_tier_vmem", "dev_coll_tier_hbm",
              "dev_coll_tier_quant", "dev_coll_fallback_size",
              "dev_coll_fallback_dtype", "coll_level_chip",
              "coll_level_ici")


def phase_fold(torch, np, mvt, ici, ring, hbm, a2a, mpit, opmod, dev,
               inputs):
    """The fold path: run_ranks(8) over a 4-device virtual mesh on cuda:0,
    2 ranks a device (DeviceFoldChannel). Allreduce of 64 MiB f32 a rank
    (4 K1 + 1 K3 a call), of 64 KiB (4 K1 + K6), a 64 MiB max (stock
    fold + K3), a 64 KiB reduce (4 K1 + K6), bcast from root 5,
    allgathers of 1 MiB (K5) and 64 KiB (K7) a rank, reduce_scatter_block
    (4 K1 + stock); then one 64 MiB allreduce over a 2-device mesh
    (2 K1 + K3). The counts are zeroed just before each run and read
    after it, the level and tier pvars checked, every result held
    against the plain reduction. Returns (launches of the 4-device run,
    e2e latencies in s)."""
    mods = (ici, ring, hbm, a2a)
    mesh = mvt.make_mesh((4,), ("x",), dev)
    rng = np.random.default_rng(SEED + 600)
    small = [_data(torch, np, rng, (SMALL_MESH,), "f32int", dev)
             for _ in range(R)]
    ag_big = [_data(torch, np, rng, (AG_MESH,), "f32int", dev)
              for _ in range(R)]
    n_check, n_warm, n_timed = 2, 1, 5
    tiny = 1024

    def app(comm):
        r = comm.rank
        me = inputs[r]
        outs = [comm.allreduce(me) for _ in range(n_check)]
        lat = _ar_lat(comm, torch, me, n_warm, n_timed)
        base = torch.arange(tiny, dtype=torch.float32, device=dev)
        res = (comm.allreduce(small[r]),
               comm.allreduce(me, op=opmod.MAX),
               comm.reduce(small[r], root=3),
               comm.bcast(base * 3 if r == 5 else torch.zeros_like(base),
                          root=5),
               comm.allgather(ag_big[r]), comm.allgather(small[r]),
               comm.reduce_scatter_block(
                   torch.arange(R * 5, dtype=torch.float32, device=dev) + r))
        torch.cuda.current_stream().synchronize()
        return outs, lat, res

    before = {k: mpit.pvar(k).read() for k in COLL_PVARS}
    _zero(*mods)
    t0 = time.perf_counter()
    res = mvt.run_ranks(R, app, device_mesh=mesh)
    torch.cuda.synchronize()
    ring.check_errors()
    wall = time.perf_counter() - t0
    n_big = n_check + n_warm + n_timed
    launches = _check_launches("fold", mods, _want(
        mods, fused_reduce_to_slot=4 * (n_big + 3),
        hbm_ring_all_reduce=n_big + 1, ring_all_reduce=2,
        hbm_ring_all_gather=1, ring_all_gather=1))
    # every chip fold of a sum reads a device's deposits in place
    fold_paths = dict(hbm.PATHS)
    if fold_paths != {**dict.fromkeys(hbm.PATHS, 0),
                      "ptrs_words": 4 * (n_big + 3)}:
        raise AssertionError(f"[fold] K1 paths {fold_paths}")
    n_calls = n_big + 7
    delta = _check_pvars(mpit, "fold", before, {
        "dev_coll_tier_vmem": R * 3, "dev_coll_tier_hbm": R * (n_big + 2),
        "dev_coll_tier_quant": 0, "dev_coll_fallback_size": 0,
        "dev_coll_fallback_dtype": 0, "coll_level_chip": R * n_calls,
        "coll_level_ici": R * n_calls})
    want = torch.stack(inputs).sum(0)
    err = 0.0
    for i in range(n_check):
        got = [res[r][0][i] for r in range(R)]
        for r in range(0, R, 2):
            if got[r] is not got[r + 1]:
                raise AssertionError("fold allreduce: the ranks of a device "
                                     "do not share its output")
        if len({g.data_ptr() for g in got}) != 4:
            raise AssertionError("fold allreduce: devices share an output")
        for g in got[::2]:
            if g.shape != (N,) or not torch.isfinite(g).all():
                raise AssertionError("fold allreduce result has the wrong "
                                     "shape or non-finite values")
            err = max(err, _compare(torch, f"fold allreduce call {i}", g,
                                    want, "f32"))
    a = torch.arange(tiny, dtype=torch.float32, device=dev)
    want_max = torch.stack(inputs).amax(0)
    want_sm = torch.stack(small).sum(0)
    for r in range(R):
        sm, mx, red, b, agb, ags, rsb = res[r][2]
        _compare(torch, "fold 64 KiB allreduce", sm, want_sm, "f32int")
        _compare(torch, "fold 64 MiB max", mx, want_max, "f32int")
        if r == 3:
            _compare(torch, "fold reduce", red, want_sm, "f32int")
        _compare(torch, "fold bcast", b, a * 3, "f32int")
        _compare(torch, "fold 1 MiB allgather", agb, torch.cat(ag_big),
                 "f32int")
        _compare(torch, "fold 64 KiB allgather", ags, torch.cat(small),
                 "f32int")
        _compare(torch, "fold reduce_scatter_block", rsb,
                 (torch.arange(r * 5, r * 5 + 5, dtype=torch.float32,
                               device=dev) * R + sum(range(R))), "f32int")
    # one allreduce over a 2-device mesh: k = 4
    _zero(*mods)
    two = mvt.run_ranks(R, lambda comm: comm.allreduce(inputs[comm.rank]),
                        device_mesh=mvt.make_mesh((2,), ("x",), dev))
    torch.cuda.synchronize()
    ring.check_errors()
    two_launches = _check_launches("fold 2-device", mods, _want(
        mods, fused_reduce_to_slot=2, hbm_ring_all_reduce=1))
    if hbm.PATHS["ptrs_words"] != 2:
        raise AssertionError(f"[fold] 2-device K1 paths {hbm.PATHS}")
    for g in two[::4]:
        err = max(err, _compare(torch, "fold 2-device allreduce", g, want,
                                "f32"))
    log(f"[fold] run_ranks({R}, device_mesh={mesh}): {n_big} allreduces of "
        f"64 MiB f32, 64 KiB allreduce, 64 MiB max, reduce, bcast, 1 MiB "
        f"and 64 KiB allgathers, reduce_scatter_block in {wall:.2f} s; "
        f"results checked (max abs err {err:.3g}); launches "
        f"{ {k: v for k, v in launches.items() if v} }; K1 paths "
        f"{ {k: v for k, v in fold_paths.items() if v} }; pvars {delta}; "
        f"2-device mesh: launches "
        f"{ {k: v for k, v in two_launches.items() if v} }")
    return launches, res[0][1]


def phase_mesh2d(torch, np, mvt, ici, ring, hbm, a2a, mpit, opmod, dev,
                 inputs):
    """The multi-axis path: run_ranks(8) bound one to one to a (2, 4) mesh
    ("x", "y") on cuda:0. Allreduce of 64 MiB f32 a rank (RS-x, RS-y,
    AG-y, AG-x: 2 K4 + 2 K5 a call), of 1 KiB (below DEV_TIER_AXES_MIN:
    one K3 an axis), an allgather of 1 MiB a rank (2 K5),
    reduce_scatter_block of 64 MiB (2 K4), bcast from root 5, alltoall of
    64 KiB (the stock lowering: no K10) and a 64 MiB max (2 K4 + 2 K5);
    then one 64 MiB allreduce on a (4, 2) mesh. The counts are zeroed
    just before each run and read after it, the tier pvars checked,
    every result held against the plain reduction. Returns (launches of
    the (2, 4) run, e2e latencies in s)."""
    mods = (ici, ring, hbm, a2a)
    mesh = mvt.make_mesh((2, 4), ("x", "y"), dev)
    rng = np.random.default_rng(SEED + 700)
    small = [_data(torch, np, rng, (SMALL_MESH,), "f32int", dev)
             for _ in range(R)]
    ag_big = [_data(torch, np, rng, (AG_MESH,), "f32int", dev)
              for _ in range(R)]
    n_check, n_warm, n_timed = 2, 1, 5
    tiny = 256

    def app(comm):
        r = comm.rank
        me = inputs[r]
        outs = [comm.allreduce(me) for _ in range(n_check)]
        lat = _ar_lat(comm, torch, me, n_warm, n_timed)
        base = torch.arange(tiny, dtype=torch.float32, device=dev)
        res = (comm.allreduce(base + r), comm.allgather(ag_big[r]),
               comm.reduce_scatter_block(me),
               comm.bcast(base * 3 if r == 5 else torch.zeros_like(base),
                          root=5),
               comm.alltoall(small[r]), comm.allreduce(me, op=opmod.MAX))
        torch.cuda.current_stream().synchronize()
        return outs, lat, res

    # the alltoall's tier, as the channel plans it for its send bytes
    tier, reason = a2a.planned_a2a_tier(SMALL_MESH * 4, torch.float32)
    a2a_pvar = (f"dev_coll_tier_{tier}" if reason is None
                else f"dev_coll_fallback_{reason}")
    before = {k: mpit.pvar(k).read() for k in COLL_PVARS + (a2a_pvar,)}
    _zero(*mods)
    t0 = time.perf_counter()
    res = mvt.run_ranks(R, app, device_mesh=mesh)
    torch.cuda.synchronize()
    ring.check_errors()
    wall = time.perf_counter() - t0
    n_big = n_check + n_warm + n_timed
    launches = _check_launches("mesh2d", mods, _want(
        mods, hbm_ring_reduce_scatter=2 * (n_big + 1) + 2,
        hbm_ring_all_gather=2 * (n_big + 1) + 2, hbm_ring_all_reduce=2))
    want_pv = {"dev_coll_tier_vmem": R, "dev_coll_tier_hbm": R * (n_big + 2),
               "dev_coll_tier_quant": 0, "dev_coll_fallback_size": 0,
               "dev_coll_fallback_dtype": 0, "coll_level_chip": 0,
               "coll_level_ici": R * (n_big + 6)}
    want_pv[a2a_pvar] = want_pv.get(a2a_pvar, 0) + R
    delta = _check_pvars(mpit, "mesh2d", before, want_pv)
    want = torch.stack(inputs).sum(0)
    err = 0.0
    for i in range(n_check):
        got = [res[r][0][i] for r in range(R)]
        if len({g.data_ptr() for g in got}) != R:
            raise AssertionError("mesh2d allreduce: ranks share an output")
        for g in got:
            if g.shape != (N,) or not torch.isfinite(g).all():
                raise AssertionError("mesh2d allreduce result has the wrong "
                                     "shape or non-finite values")
            err = max(err, _compare(torch, f"mesh2d allreduce call {i}", g,
                                    want, "f32"))
    a = torch.arange(tiny, dtype=torch.float32, device=dev)
    want_max = torch.stack(inputs).amax(0)
    blk = N // R
    want_a2a = torch.stack(small).reshape(R, R, -1)
    for r in range(R):
        t, agb, rsb, b, a2, mx = res[r][2]
        _compare(torch, "mesh2d 1 KiB allreduce", t, a * R + sum(range(R)),
                 "f32int")
        _compare(torch, "mesh2d 1 MiB allgather", agb, torch.cat(ag_big),
                 "f32int")
        err = max(err, _compare(torch, "mesh2d reduce_scatter_block", rsb,
                                want[r * blk:(r + 1) * blk], "f32"))
        _compare(torch, "mesh2d bcast", b, a * 3, "f32int")
        _compare(torch, "mesh2d alltoall", a2,
                 want_a2a[:, r].reshape(-1), "f32int")
        _compare(torch, "mesh2d 64 MiB max", mx, want_max, "f32int")
    # one allreduce on a (4, 2) mesh
    _zero(*mods)
    other = mvt.run_ranks(R, lambda comm: comm.allreduce(inputs[comm.rank]),
                          device_mesh=mvt.make_mesh((4, 2), ("x", "y"), dev))
    torch.cuda.synchronize()
    ring.check_errors()
    other_launches = _check_launches("mesh2d (4, 2)", mods, _want(
        mods, hbm_ring_reduce_scatter=2, hbm_ring_all_gather=2))
    for g in other:
        err = max(err, _compare(torch, "(4, 2) allreduce", g, want, "f32"))
    log(f"[mesh2d] run_ranks({R}, device_mesh={mesh}): {n_big} allreduces "
        f"of 64 MiB f32, 1 KiB allreduce, 1 MiB allgather, 64 MiB "
        f"reduce_scatter_block, bcast, 64 KiB alltoall, 64 MiB max in "
        f"{wall:.2f} s; results checked (max abs err {err:.3g}); launches "
        f"{ {k: v for k, v in launches.items() if v} }; pvars {delta}; "
        f"(4, 2) mesh: launches "
        f"{ {k: v for k, v in other_launches.items() if v} }")
    return launches, res[0][1]


def phase_sendrecv(torch, ici, ring, dev, inputs):
    """The exchange a user calls: ici.remote_sendrecv on the 8 ranks' 64
    MiB f32 shards, ranks 2 and 5 swapping (K8, 3 calls; the JAX package
    has no caller of its own). The counts are zeroed just before and read
    after; each result is held against the swapped inputs. Returns the
    launch counts."""
    _zero(ici, ring)
    outs = [ici.remote_sendrecv(inputs, 2, 5) for _ in range(3)]
    torch.cuda.synchronize()
    ring.check_errors()
    launches = _check_launches("sendrecv", (ici, ring),
                               _want((ici, ring), remote_sendrecv=3))
    if ici.PATHS != {"sendrecv_bulk_rows": 3 * R,
                     "sendrecv_element_rows": 0}:
        raise AssertionError(f"[sendrecv] rows {ici.PATHS}: every row of "
                             f"the aligned shards goes by bulk tiles")
    part = list(range(R))
    part[2], part[5] = 5, 2
    for out in outs:
        for r in range(R):
            _compare(torch, f"sendrecv row {r}", out[r], inputs[part[r]],
                     "f32int")
    log(f"[sendrecv] 3 exchanges of 8 x 64 MiB f32 (2 <-> 5): launches "
        f"{ {k: v for k, v in launches.items() if v} }, rows {ici.PATHS}; "
        f"rows checked")
    return launches


def phase_mesh_a2a(torch, np, mvt, a2a, ring, mpit, moe, dev):
    """The 1:1 path's alltoall(v): run_ranks(8) bound one to one to a
    mesh of 8 virtual ranks on cuda:0; comm.alltoall of 64 MiB f32 a rank
    (K10, 2 checked calls, 2 warm-ups, 10 timed) and comm.alltoallv of
    the MoE bench's hot routing at 4096 tokens x 4096 (K11, 2 calls),
    each held against numpy. K10/K11's launch counts are zeroed before
    the run and read after it; dev_coll_tier_hbm must move by 8 a call.
    Returns (launch counts, e2e alltoall latencies in s)."""
    mesh = mvt.make_mesh((R,), ("x",), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 500)
    xs = [torch.randn(N, generator=gen, device=dev) for _ in range(R)]
    counts = _moe_counts(moe, "hot")
    vs = [torch.randn(sum(counts[r]), generator=gen, device=dev)
          for r in range(R)]
    n_check, n_warm, n_timed, n_v = 2, 2, 10, 2

    def app(comm):
        r, p = comm.rank, comm.size
        stream = torch.cuda.current_stream()
        outs = [comm.alltoall(xs[r]) for _ in range(n_check)]
        for _ in range(n_warm):
            comm.alltoall(xs[r])
        lat = []
        for _ in range(n_timed):
            t0 = time.perf_counter()
            comm.alltoall(xs[r])
            stream.synchronize()
            lat.append(time.perf_counter() - t0)
        rc = [counts[j][r] for j in range(p)]
        vouts = [comm.alltoallv(vs[r], counts[r], None, None, rc, None)
                 for _ in range(n_v)]
        stream.synchronize()
        return outs, lat, vouts

    hbm0 = mpit.pvar("dev_coll_tier_hbm").read()
    a2a.reset_counts()
    t0 = time.perf_counter()
    res = mvt.run_ranks(R, app, device_mesh=mesh)
    torch.cuda.synchronize()
    ring.check_errors()
    wall = time.perf_counter() - t0
    launches = dict(a2a.LAUNCHES)
    plain = dict(a2a.PLAIN_CALLS)
    n_a2a = n_check + n_warm + n_timed
    if launches != {"hbm_alltoall": n_a2a, "hbm_alltoallv": n_v}:
        raise AssertionError(f"alltoall launches on the mesh path "
                             f"{launches}, expected {n_a2a} and {n_v}")
    if any(plain.values()):
        raise AssertionError(f"plain alltoall calls on the card: {plain}")
    moved = mpit.pvar("dev_coll_tier_hbm").read() - hbm0
    if moved != R * (n_a2a + n_v):
        raise AssertionError(f"dev_coll_tier_hbm moved by {moved}, "
                             f"expected {R} a call")
    # against numpy
    c = N // R
    host = np.stack([x.cpu().numpy() for x in xs]).reshape(R, R, c)
    vhost = [v.cpu().numpy() for v in vs]
    sd = [np.cumsum([0] + row[:-1]) for row in counts]
    for r in range(R):
        want = host[:, r, :].reshape(-1)
        for g in res[r][0]:
            if g.shape != (N,) or not np.array_equal(g.cpu().numpy(), want):
                raise AssertionError(f"mesh alltoall rank {r}: wrong")
        vwant = np.concatenate([vhost[j][sd[j][r]:sd[j][r] + counts[j][r]]
                                for j in range(R)])
        for g in res[r][2]:
            if not np.array_equal(g.cpu().numpy(), vwant):
                raise AssertionError(f"mesh alltoallv rank {r}: wrong")
    log(f"[mesh] run_ranks({R}, device_mesh={mesh}): {n_a2a} alltoalls of "
        f"64 MiB f32 a rank and {n_v} alltoallvs of the hot routing at "
        f"{MOE_TOKENS} x {MOE_DMODEL} (rank 0 receives "
        f"{sum(counts[j][0] for j in range(R)) * 4 >> 20} MiB) in "
        f"{wall:.2f} s; results equal numpy's; launches {launches}, plain "
        f"calls {plain}; dev_coll_tier_hbm +{moved:.0f}")
    return launches, res[0][1]


NBC_SMALL = 16 * 1024              # f32 elements: 64 KiB a rank (K7)
NBC_ODD = 1001                     # int32 elements of the unaligned case
NBC_MATMUL = 4096                  # the overlap phase's matmul: 4096^2 f32
NBC_RUNS = 5                       # overlap iterations timed, after 1


def _timed_mark(marks, kind, fn):
    """``fn`` appending (thread name, ``kind``, t0, t1) to ``marks``."""
    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            marks.append((threading.current_thread().name, kind, t0,
                          time.perf_counter()))
    return timed


def _nb_host_timers(coll_dev):
    """perf_counter wrappers around the channel's ``_nb_launch``,
    ``_nb_poll`` and ``_nb_finish``; returns (marks, restore). A mark is
    (thread name, kind, t0, t1)."""
    marks = []
    cls = coll_dev._Channel         # where every channel's NBC tier lives
    saved = {k: cls.__dict__[k] for k in ("_nb_launch", "_nb_poll",
                                          "_nb_finish")}
    for k, fn in saved.items():
        setattr(cls, k, _timed_mark(marks, k[4:], fn))

    def restore():
        for k, fn in saved.items():
            setattr(cls, k, fn)
    return marks, restore


def phase_nbc(torch, np, mvt, ici, ring, a2a, mpit, cfg, moe, smi, dev):
    """[nbc]: the nonblocking and persistent device collectives on the
    1:1 mesh of 8 virtual ranks (see the module docstring, phase 13).
    Returns the phase's figures."""
    from mvapich2_tpu_torch.coll import device as coll_dev
    from mvapich2_tpu_torch.core import request as nbreq
    from mvapich2_tpu_torch.core.errors import (MPIX_ERR_PROC_FAILED,
                                                MPIException)
    t_phase = time.perf_counter()
    mods = (ici, ring, a2a)
    mesh = mvt.make_mesh((R,), ("x",), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 900)
    seg_bytes = cfg["DEVICE_NBC_SEG_BYTES"]      # 1 MiB: 8 segments of N

    def ints(n, dtype=torch.float32):
        return torch.randint(-1000, 1000, (n,), generator=gen, device=dev,
                             dtype=torch.int32).to(dtype)
    big = [ints(N) for _ in range(R)]
    small = [ints(NBC_SMALL) for _ in range(R)]
    ag = [ints(AG_MESH) for _ in range(R)]
    a2 = [ints(N) for _ in range(R)]
    odd = [ints(NBC_ODD, torch.int32) for _ in range(R)]
    counts = _moe_counts(moe, "hot")
    vs = [ints(sum(counts[r])) for r in range(R)]
    bc = ints(N)
    figures = {}

    # 1. every i-collective once, routed to the device, results landed
    def app_nb(comm):
        r, p = comm.rank, comm.size
        rc = [counts[j][r] for j in range(p)]
        outs = {"allreduce": np.empty(N, np.float32),
                "bcast": (bc.cpu().numpy() if r == 5
                          else np.zeros(N, np.float32)),
                "allgather_k5": np.empty(AG_MESH * p, np.float32),
                "allgather_k7": np.empty(NBC_SMALL * p, np.float32),
                "alltoall": np.empty(N, np.float32),
                "alltoallv": np.empty(sum(rc), np.float32)}
        reqs = [comm.iallreduce(big[r], outs["allreduce"]),
                comm.ibcast(outs["bcast"], root=5),
                comm.iallgather(ag[r], outs["allgather_k5"]),
                comm.iallgather(small[r], outs["allgather_k7"]),
                comm.ialltoall(a2[r], outs["alltoall"]),
                comm.ialltoallv(vs[r], counts[r], None, outs["alltoallv"],
                                rc, None)]
        flags = [q.device_nbc for q in reqs]
        nbreq.waitall(reqs)
        return outs, flags

    def app_block(comm):
        r, p = comm.rank, comm.size
        rc = [counts[j][r] for j in range(p)]
        got = {"allreduce": comm.allreduce(big[r]),
               "bcast": comm.bcast(bc if r == 5 else torch.zeros_like(bc),
                                   root=5),
               "allgather_k5": comm.allgather(ag[r]),
               "allgather_k7": comm.allgather(small[r]),
               "alltoall": comm.alltoall(a2[r]),
               "alltoallv": comm.alltoallv(vs[r], counts[r], None, None,
                                           rc, None)}
        torch.cuda.current_stream().synchronize()
        return {k: v.cpu().numpy() for k, v in got.items()}

    pv = ("dev_nbc_segments", "dev_coll_tier_hbm", "dev_coll_tier_vmem",
          "coll_level_ici", "dev_coll_fallback_nbc")
    before = {k: mpit.pvar(k).read() for k in pv}
    _zero(*mods)
    t0 = time.perf_counter()
    res = mvt.run_ranks(R, app_nb, device_mesh=mesh)
    wall = time.perf_counter() - t0
    launches = _check_launches("nbc", mods, _want(
        mods, hbm_ring_all_reduce=8, hbm_ring_all_gather=1,
        ring_all_gather=1, hbm_alltoall=1, hbm_alltoallv=1))
    _check_pvars(mpit, "nbc", before, {
        "dev_nbc_segments": 8 + 8 + 4, "dev_coll_tier_hbm": 0,
        "dev_coll_tier_vmem": 0, "coll_level_ici": 0,
        "dev_coll_fallback_nbc": 0})
    blocking = mvt.run_ranks(R, app_block, device_mesh=mesh)
    for r in range(R):
        outs, flags = res[r]
        if not all(flags):
            raise AssertionError(f"[nbc] rank {r}: device_nbc {flags}")
        for k, got in outs.items():
            if not np.array_equal(got, blocking[r][k]):
                raise AssertionError(f"[nbc] i{k} rank {r}: not bitwise the "
                                     f"blocking call")
    if not np.array_equal(res[0][0]["allreduce"],
                          torch.stack(big).sum(0).cpu().numpy()):
        raise AssertionError("[nbc] iallreduce: not the plain sum")
    log(f"[nbc] run_ranks({R}, device_mesh={mesh}): iallreduce 64 MiB f32 "
        f"(8 segments), ibcast 64 MiB (8), iallgather 1 MiB and 64 KiB, "
        f"ialltoall 64 MiB, ialltoallv of the hot MoE routing, all posted "
        f"then waitall, in {wall:.2f} s; every request device_nbc; results "
        f"bitwise the blocking calls'; launches {launches}")
    figures["launches"] = launches

    # 2. the unaligned segmentation: 1001 int32 at 256-byte segments
    cfg.set("DEVICE_NBC_SEG_BYTES", 256)
    try:
        def app_odd(comm):
            out = np.empty(NBC_ODD, np.int32)
            comm.iallreduce(odd[comm.rank], out).wait()
            return out
        _zero(*mods)
        res = mvt.run_ranks(R, app_odd, device_mesh=mesh)
        _check_launches("nbc unaligned", mods,
                        _want(mods, hbm_ring_all_reduce=8))
    finally:
        cfg.set("DEVICE_NBC_SEG_BYTES", seg_bytes)
    want_odd = mvt.run_ranks(R, lambda comm: comm.allreduce(
        odd[comm.rank]).cpu().numpy(), device_mesh=mesh)
    plain_odd = torch.stack(odd).sum(0, dtype=torch.int32).cpu().numpy()
    for r in range(R):
        if not np.array_equal(res[r], want_odd[r]) or not np.array_equal(
                res[r], plain_odd):
            raise AssertionError(f"[nbc] unaligned iallreduce rank {r}")
    log(f"[nbc] 1001 int32 tensors at DEVICE_NBC_SEG_BYTES=256: 8 K3 "
        f"launches on segments 504 B apart (not 16-byte aligned), bitwise "
        f"the blocking call and the plain sum")

    # 3. the (2, 4) mesh: each 8 MiB segment runs 2 K4 + 2 K5
    mesh24 = mvt.make_mesh((2, 4), ("x", "y"), dev)

    def app_24(comm):
        out = np.empty(N, np.float32)
        req = comm.iallreduce(big[comm.rank], out)
        req.wait()
        return out, req.device_nbc
    _zero(*mods)
    res = mvt.run_ranks(R, app_24, device_mesh=mesh24)
    _check_launches("nbc (2, 4)", mods, _want(
        mods, hbm_ring_reduce_scatter=16, hbm_ring_all_gather=16))
    want24 = mvt.run_ranks(R, lambda comm: comm.allreduce(
        big[comm.rank]).cpu().numpy(), device_mesh=mesh24)
    for r in range(R):
        if not res[r][1] or not np.array_equal(res[r][0], want24[r]):
            raise AssertionError(f"[nbc] (2, 4) iallreduce rank {r}")
    log("[nbc] (2, 4) mesh iallreduce of 64 MiB f32: 8 segments, 16 K4 + "
        "16 K5, bitwise the blocking call")

    # 4. a persistent allreduce_init, 3 starts
    def app_pers(comm):
        out = np.empty(N, np.float32)
        req = comm.allreduce_init(big[comm.rank], out)
        built = sorted(k[1] for k in comm.device_channel._programs
                       if k[0] == "allreduce")
        got = []
        for _ in range(3):
            out[:] = np.nan
            req.start()
            req.wait()
            got.append(out.copy())
        return built, got
    p0 = mpit.pvar("dev_persistent_starts").read()
    _zero(*mods)
    res = mvt.run_ranks(R, app_pers, device_mesh=mesh)
    _check_launches("nbc persistent", mods,
                    _want(mods, hbm_ring_all_reduce=24))
    starts = mpit.pvar("dev_persistent_starts").read() - p0
    if starts != R * 3:
        raise AssertionError(f"[nbc] dev_persistent_starts +{starts}, "
                             f"expected {R * 3}")
    seg = N // 8
    for r in range(R):
        built, got = res[r]
        if built != [seg]:
            raise AssertionError(f"[nbc] rank {r}: after init _programs "
                                 f"holds {built}, expected [{seg}]")
        for g in got:
            if not np.array_equal(g, blocking[r]["allreduce"]):
                raise AssertionError(f"[nbc] persistent start rank {r}")
    log(f"[nbc] allreduce_init of 64 MiB f32: init built the segment "
        f"program ({seg} elements), 3 starts x 8 segments = 24 K3 launches, "
        f"dev_persistent_starts +{starts:.0f}, each start bitwise")

    # 5. no launch waits for the card: one 64 MiB segment's event reads
    # not ready as soon as its launch returns
    ready_after = []
    real_launch = coll_dev._Channel._nb_launch

    def launch_and_query(self, *a, **k):
        outs, ev = real_launch(self, *a, **k)
        ready_after.append(ev.query())
        return outs, ev
    coll_dev._Channel._nb_launch = launch_and_query
    cfg.set("DEVICE_NBC_SEG_BYTES", 0)
    try:
        def app_one(comm):
            out = np.empty(N, np.float32)
            comm.iallreduce(big[comm.rank], out).wait()
            return out
        res = mvt.run_ranks(R, app_one, device_mesh=mesh)
    finally:
        cfg.set("DEVICE_NBC_SEG_BYTES", seg_bytes)
        coll_dev._Channel._nb_launch = real_launch
    if ready_after != [False]:
        raise AssertionError(f"[nbc] a 64 MiB segment's event read "
                             f"{ready_after} right after its launch")
    for r in range(R):
        if not np.array_equal(res[r], blocking[r]["allreduce"]):
            raise AssertionError(f"[nbc] one-segment iallreduce rank {r}")
    log("[nbc] one 64 MiB segment: its event reads query() == False right "
        "after the launch returns")

    # 6. overlap, recorded with no limit and no claim: the blocking
    # allreduce then a matmul, against iallreduce, the matmul, wait()
    mats = [torch.randn(NBC_MATMUL, NBC_MATMUL, generator=gen, device=dev)
            for _ in range(R)]
    marks, restore = _nb_host_timers(coll_dev)

    def app_overlap(comm):
        r = comm.rank
        stream = torch.cuda.current_stream()
        out = np.empty(N, np.float32)
        times = {"blocking": [], "nonblocking": [], "matmul_alone": [],
                 "allreduce_alone": [], "iallreduce_alone": []}
        alone = {"matmul_alone": lambda: torch.matmul(mats[r], mats[r]),
                 "allreduce_alone": lambda: comm.allreduce(big[r], out),
                 "iallreduce_alone": lambda: comm.iallreduce(
                     big[r], out).wait()}
        posts, waits = [], []
        for key, fn in alone.items():
            for _ in range(1 + NBC_RUNS):
                t0 = time.perf_counter()
                fn()
                stream.synchronize()
                times[key].append(time.perf_counter() - t0)
        for _ in range(1 + NBC_RUNS):
            t0 = time.perf_counter()
            comm.allreduce(big[r], out)
            torch.matmul(mats[r], mats[r])
            stream.synchronize()
            times["blocking"].append(time.perf_counter() - t0)
        for _ in range(1 + NBC_RUNS):
            t0 = time.perf_counter()
            req = comm.iallreduce(big[r], out)
            t1 = time.perf_counter()
            torch.matmul(mats[r], mats[r])
            t2 = time.perf_counter()
            req.wait()
            stream.synchronize()
            t3 = time.perf_counter()
            times["nonblocking"].append(t3 - t0)
            posts.append(t1 - t0)
            waits.append(t3 - t2)
        return times, posts, waits
    try:
        res = mvt.run_ranks(R, app_overlap, device_mesh=mesh)
    finally:
        restore()
    med = {k: statistics.median(t for r in range(R)
                                for t in res[r][0][k][1:]) * 1e3
           for k in res[0][0]}
    per_rank = {k: [round(statistics.median(res[r][0][k][1:]) * 1e3, 3)
                    for r in range(R)] for k in med}
    # host split of the nonblocking calls: the launches are made by
    # whichever rank polls first once all have posted (8 a call, the
    # first also stages), every rank polls and finishes; launches are
    # timed inside the polls that made them
    kinds = collections.defaultdict(list)
    for thread, kind, a, b in marks:
        kinds[kind].append(b - a)
    n_calls = 2 * (1 + NBC_RUNS)    # iallreduce alone, then overlapped
    launch = kinds["launch"]
    if len(launch) != 8 * n_calls:
        raise AssertionError(f"[nbc] {len(launch)} segment launches in "
                             f"{n_calls} calls")
    split = {
        "post_us": statistics.median(t for r in range(R)
                                     for t in res[r][1][1:]) * 1e6,
        "first_launch_us": statistics.median(
            launch[i * 8] for i in range(1, n_calls)) * 1e6,
        "other_7_launches_us": statistics.median(
            sum(launch[i * 8 + 1:(i + 1) * 8]) for i in range(1, n_calls))
        * 1e6,
        "polls_a_call": len(kinds["poll"]) / n_calls,
        "polls_but_launches_us_a_call": (sum(kinds["poll"]) - sum(launch))
        / n_calls * 1e6,
        "finish_us": statistics.median(kinds["finish"]) * 1e6,
        "wait_us": statistics.median(t for r in range(R)
                                     for t in res[r][2][1:]) * 1e6}
    log(f"[nbc] {smi}: overlap, 8 ranks, 64 MiB f32 allreduce (numpy "
        f"recvbuf) + one {NBC_MATMUL}^2 f32 matmul a rank, median of "
        f"{NBC_RUNS} after 1 over the ranks: blocking then matmul "
        f"{med['blocking']:.3f} ms, iallreduce + matmul + wait "
        f"{med['nonblocking']:.3f} ms; alone: matmul "
        f"{med['matmul_alone']:.3f}, allreduce {med['allreduce_alone']:.3f}, "
        f"iallreduce + wait {med['iallreduce_alone']:.3f} ms; per rank "
        f"{per_rank}")
    log(f"[nbc] {smi}: host split of the iallreduce, us: " + ", ".join(
        f"{k} {v:.1f}" for k, v in split.items()))
    figures["overlap_ms"] = med
    figures["overlap_per_rank_ms"] = per_rank
    figures["host_split"] = split

    # 7. a rank that fails after its peers posted
    outcome = {}

    def app_dead(comm):
        x = small[comm.rank]
        if comm.rank == 3:
            time.sleep(0.3)
            raise RuntimeError("the victim dies")
        t0 = time.perf_counter()
        try:
            comm.iallreduce(x, np.empty(NBC_SMALL, np.float32)).wait()
            outcome[comm.rank] = "completed"
        except MPIException as e:
            outcome[comm.rank] = (e.error_class, time.perf_counter() - t0)
    t0 = time.perf_counter()
    try:
        mvt.run_ranks(R, app_dead, device_mesh=mesh, timeout=60)
    except RuntimeError as e:
        if "the victim dies" not in repr(e):
            raise
    else:
        raise AssertionError("[nbc] the victim's failure did not surface")
    took = time.perf_counter() - t0
    if sorted(outcome) != [r for r in range(R) if r != 3] or not all(
            v[0] == MPIX_ERR_PROC_FAILED and v[1] < 5
            for v in outcome.values()):
        raise AssertionError(f"[nbc] peers of a dead rank: {outcome}")
    if mpit.pvar("nbc_scheds_active").read() != 0:
        raise AssertionError("[nbc] a schedule was left active")
    figures["dead_rank_wait_s"] = max(v[1] for v in outcome.values())
    log(f"[nbc] a rank dies after its peers posted: every peer's wait() "
        f"raised MPIX_ERR_PROC_FAILED within "
        f"{max(v[1] for v in outcome.values()):.3f} s (run {took:.2f} s)")

    # 8. [trace]: one traced iallreduce through bin/mv2tconform
    d = tempfile.mkdtemp(prefix="mv2t-nbc-trace-")
    cfg.set("TRACE", True)
    cfg.set("TRACE_DIR", d)
    try:
        mvt.run_ranks(R, app_one, device_mesh=mesh)
    finally:
        cfg.set("TRACE", False)
        cfg.set("TRACE_DIR", "")
    names = collections.Counter(ev[2] for dump in _read_dumps(d).values()
                                for ev in dump if ev[1] in ("nbc", "device"))
    if names["nbc_dev_issue"] != 8 or names["nbc_dev_complete"] != 8 or \
            names["sched_complete"] != R:
        raise AssertionError(f"[nbc] traced iallreduce events {names}")
    conform = subprocess.run(
        [sys.executable, os.path.join(HERE, "bin", "mv2tconform"), d],
        capture_output=True, text=True, timeout=120)
    verdict = (conform.stdout.strip().splitlines() or [""])[-1]
    if conform.returncode != 0:
        raise AssertionError(f"[nbc] bin/mv2tconform exited "
                             f"{conform.returncode}: {conform.stdout[-3000:]}"
                             f"{conform.stderr[-2000:]}")
    import shutil
    shutil.rmtree(d, ignore_errors=True)
    log(f"[trace] nbc: one traced iallreduce, 8 segments, "
        f"{sum(names.values())} nbc and device events; bin/mv2tconform "
        f"exit 0 ({verdict})")
    figures["mv2tconform"] = verdict
    figures["phase_s"] = time.perf_counter() - t_phase
    log(f"[nbc] phase took {figures['phase_s']:.2f} s")
    return figures


MODELS_SMALL = 512                 # f32 elements: a 2 KiB shard, below the edge
MODELS_STEPS = 6                   # train steps at the default Config()
MODELS_CFG = {}                    # Config() overrides (none on the card)
STENCIL_GRID = 512                 # BASELINE config 4's grid
STENCIL_ITERS = 4
STEP_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_torch_models.py's
LOSS_RTOL = 1e-5


def _models_allreduce(torch, np, ici, ring, mods, MeshComm, make_mesh,
                      timing, dev):
    """The multi-axis MeshComm.allreduce (see phase_models). Returns its
    launch counts and figures."""
    rng = np.random.default_rng(SEED + 1300)
    runs = []
    # (mesh shape, axis names, comm axes, payload, op, K4, K5, K3)
    cases = [((2, 4), ("x", "y"), ("x", "y"), N, "sum", 2, 2, 0),
             ((2, 4), ("x", "y"), ("x", "y"), N, "max", 2, 2, 0),
             ((2, 4), ("x", "y"), ("x", "y"), MODELS_SMALL, "sum", 0, 0, 2),
             ((2, 2, 2), ("dp", "sp", "tp"), ("dp", "sp"), N, "sum", 2, 2,
              0),
             ((2, 2, 2), ("dp", "sp", "tp"), ("dp", "sp", "tp"), N, "sum",
              3, 3, 0),
             ((2, 2, 2), ("dp", "sp", "tp"), ("dp", "sp", "tp"),
              MODELS_SMALL, "max", 0, 0, 3)]
    launches = {}
    for shape, names, axes, n, op, k4, k5, k3 in cases:
        comm = MeshComm(make_mesh(shape, names, dev), axes)
        x = _data(torch, np, rng, (R, n), "f32int", dev)
        _zero(*mods)
        got = comm.allreduce(x, op)
        torch.cuda.synchronize()
        ring.check_errors()
        what = f"models allreduce {shape} over {axes} {op} n={n}"
        launches[what] = _check_launches(what, mods, _want(
            mods, hbm_ring_reduce_scatter=k4, hbm_ring_all_gather=k5,
            hbm_ring_all_reduce=k3))
        # the plain version: the stock reduction of each group
        g = comm.group(x)
        red = g.sum(1) if op == "sum" else g.amax(1)
        want = comm.ungroup(red[:, None].expand_as(g))
        _compare(torch, what, got, want, "f32int")
        runs.append(what)
    comm = MeshComm(make_mesh((2, 4), ("x", "y"), dev), ("x", "y"))
    x = _data(torch, np, rng, (R, N), "f32int", dev)
    card_ms = timing.time_ms(lambda: comm.allreduce(x), warmup=1, iters=5)
    # MeshComm stacks the rows that ici_all_reduce_mesh returns: that
    # copy's own card time, its share of the call
    rows = ici.ici_all_reduce_mesh(list(x.unbind(0)), (("x", 2), ("y", 4)))
    stack_ms = timing.time_ms(lambda: torch.stack(rows), warmup=1, iters=5)
    return launches, {"checked": runs, "mesh2x4_64MiB_card_ms": card_ms,
                      "mesh2x4_64MiB_stack_card_ms": stack_ms}


def phase_models(torch, np, ici, ring, hbm, a2a, smi, dev):
    """The models slice on virtual ranks of one card (module docstring,
    phase 14): the multi-axis MeshComm.allreduce, the transformer's train
    step at the default Config() on the (2, 2, 2) mesh, the 512^3
    stencil and the pipeline demo. Returns the phase's figures."""
    from mvapich2_tpu_torch import carry
    from mvapich2_tpu_torch.models import stencil as st
    from mvapich2_tpu_torch.models import transformer as tf
    from mvapich2_tpu_torch.ops import collectives as coll
    from mvapich2_tpu_torch.parallel import MeshComm, P, make_mesh
    from mvapich2_tpu_torch.parallel.pipeline import pipeline_apply
    from mvapich2_tpu_torch.utils import timing
    t_phase = time.perf_counter()
    mods = (ici, ring, hbm, a2a)
    _set_f32_matmul(torch, False)
    ar_launches, ar = _models_allreduce(torch, np, ici, ring, mods,
                                        MeshComm, make_mesh, timing, dev)
    log(f"[models] multi-axis allreduce: {len(ar['checked'])} calls "
        f"checked bitwise, launches "
        f"{ {w: {k: v for k, v in l.items() if v} for w, l in ar_launches.items()} }; "
        f"(2, 4) 64 MiB f32 a rank: {ar['mesh2x4_64MiB_card_ms']:.4f} ms "
        f"card time (median of 5 by CUDA events), of which the stack of "
        f"the result rows {ar['mesh2x4_64MiB_stack_card_ms']:.4f} ms, on "
        f"{smi}")

    # the transformer: default Config() on the (2, 2, 2) mesh
    cfg = tf.Config(**MODELS_CFG)
    _zero(*mods)
    cfg, mesh, params, tokens, step = tf.demo_setup(cfg, device=dev)
    if tuple(mesh.shape.values()) != (2, 2, 2):
        raise AssertionError(f"[models] demo mesh {mesh}")
    cpu_mesh = make_mesh((2, 2, 2), tf.AXES, "cpu")
    cpu_new, cpu_loss = tf.make_train_step(cfg, cpu_mesh)(
        {k: v.cpu() for k, v in params.items()}, tokens.cpu())
    losses, step_s = [], []
    for i in range(MODELS_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, loss = step(params, tokens)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if i == 0:
            first_new = new
        params = new
        losses.append(float(loss))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[models] the loss did not fall: {losses}")
    if abs(losses[0] - float(cpu_loss)) > LOSS_RTOL * abs(float(cpu_loss)):
        raise AssertionError(f"[models] step 1 loss {losses[0]} vs the CPU "
                             f"run's {float(cpu_loss)}")
    got = carry.params_to_numpy(first_new, cfg, mesh)
    want = carry.params_to_numpy(cpu_new, cfg, cpu_mesh)
    param_err = 0.0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **STEP_TOL)
        param_err = max(param_err, float(np.abs(got[k] - want[k]).max()))
    if any(_launches(*mods).values()):
        raise AssertionError(f"[models] the train step launched "
                             f"{_launches(*mods)}: it runs stock torch")
    # the dense model: one device and (2, 2, 2) give the same first loss
    dense = tf.Config(**{**MODELS_CFG, "moe_layer": -1})
    gen = torch.Generator().manual_seed(0)
    glob = tf.init_params(dense, gen, dev)
    toks = torch.randint(0, dense.vocab, (dense.batch, dense.seq_len),
                         generator=torch.Generator().manual_seed(1))
    dense_loss = []
    for shape in ((1, 1, 1), (2, 2, 2)):
        m = make_mesh(shape, tf.AXES, dev)
        _, l1 = tf.make_train_step(dense, m)(tf.shard_params(glob, dense, m),
                                             tf.shard_tokens(toks.to(dev), m))
        dense_loss.append(float(l1))
    if abs(dense_loss[0] - dense_loss[1]) > 1e-3 * abs(dense_loss[0]):
        raise AssertionError(f"[models] dense first loss (1, 1, 1) vs "
                             f"(2, 2, 2): {dense_loss}")
    med_step = statistics.median(step_s[1:])
    log(f"[models] train step, default Config() (vocab {cfg.vocab}, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_layers} layers, d_ff "
        f"{cfg.d_ff}, seq {cfg.seq_len}, batch {cfg.batch}, {cfg.n_experts} "
        f"experts, MoE at layer {cfg.moe_layer}) on {mesh}: losses "
        f"{[round(v, 5) for v in losses]}; step 1 against the CPU run: loss "
        f"{losses[0]!r} vs {float(cpu_loss)!r}, params max abs err "
        f"{param_err:.3g}; median step {med_step * 1e3:.2f} ms host clock "
        f"(steps 2-{MODELS_STEPS}, first {step_s[0] * 1e3:.1f} ms); dense "
        f"first loss (1, 1, 1) {dense_loss[0]!r} vs (2, 2, 2) "
        f"{dense_loss[1]!r}; on {smi}")

    # the stencil: 512^3 f32 split on z over 8 virtual ranks, periodic
    zcomm = MeshComm(make_mesh((R,), ("z",), dev))
    u = st.initial_grid(STENCIL_GRID, dev)
    _zero(*mods)
    out = st.run_stencil(zcomm, STENCIL_GRID, STENCIL_ITERS, True, u=u)
    want_u = st.reference_stencil(u, STENCIL_ITERS, True)
    torch.cuda.synchronize()
    if out.shape != (STENCIL_GRID,) * 3 or not torch.isfinite(out).all():
        raise AssertionError("[models] stencil: shape or non-finite")
    st_err = (out - want_u).abs().max().item()
    if not torch.allclose(out, want_u, rtol=1e-6, atol=1e-7):
        raise AssertionError(f"[models] stencil against its reference: max "
                             f"abs err {st_err}")
    del want_u
    st_ms = timing.time_ms(lambda: st.run_stencil(
        zcomm, STENCIL_GRID, STENCIL_ITERS, True, u=u), warmup=1,
        iters=3) / STENCIL_ITERS
    del u, out
    log(f"[models] stencil {STENCIL_GRID}^3 f32, z over {R} virtual ranks, "
        f"{STENCIL_ITERS} periodic iterations: max abs err {st_err:.3g} "
        f"against reference_stencil; {st_ms:.3f} ms an iteration (median "
        f"of 3 runs by CUDA events) on {smi}")

    # the pipeline demo of the graft entry: 8 affine stages
    D, n_micro = 16, 2 * R
    ws = torch.stack([torch.eye(D) * (1.0 + 0.01 * i) for i in range(R)])
    micro = torch.randn((n_micro, 4, D),
                        generator=torch.Generator().manual_seed(2))
    pcomm = MeshComm(make_mesh((R,), ("pp",), dev))

    def run(w, m):
        return coll.allreduce(pipeline_apply(
            lambda a, b: b @ a[:, 0], w, m, pcomm), pcomm)
    pout = pcomm.run(run, ws.to(dev), micro.to(dev),
                     in_specs=(P("pp"), P()), out_specs=P())
    scale = float(np.prod([1.0 + 0.01 * i for i in range(R)],
                          dtype=np.float32))
    if not torch.allclose(pout.cpu(), micro * scale, rtol=1e-5, atol=1e-6):
        raise AssertionError("[models] pipeline output")
    if any(_launches(*mods).values()):
        raise AssertionError(f"[models] stencil/pipeline launched "
                             f"{_launches(*mods)}")
    total = time.perf_counter() - t_phase
    log(f"[models] pipeline over {R} stages: {n_micro} microbatches of "
        f"{tuple(micro.shape[1:])} checked; phase {total:.1f} s")
    state = (step, params, tokens, med_step, zcomm, st_ms)
    return state, {"allreduce": ar, "allreduce_launches": ar_launches,
                   "losses": losses, "step_s": step_s, "median_step_ms":
                   med_step * 1e3, "cpu_loss": float(cpu_loss),
                   "param_max_abs_err": param_err,
                   "dense_first_loss": dense_loss,
                   "stencil_ms_per_iter": st_ms,
                   "stencil_max_abs_err": st_err, "phase_s": total,
                   "nvidia_smi": smi}


def _models_group(key):
    k = key.lower()
    if "gemm" in k or "cutlass" in k or "xmma" in k:
        return "gemm"
    if "index" in k or "scatter" in k or "gather" in k:
        return "index"
    if "reduce" in k or "softmax" in k or "norm" in k:
        return "reduce"
    return "elementwise_copy"


def phase_models_profile(torch, state):
    """One train step and one stencil iteration of [models] under
    torch.profiler: device time by kernel group (gemm, index,
    reduce, elementwise and copies), the kernels launched, and the idle
    share against the unprofiled median (1 - busy / median). Run last,
    as the other profiles."""
    from torch.profiler import ProfilerActivity, profile
    from mvapich2_tpu_torch.models import stencil as st
    step, params, tokens, med_step, zcomm, st_ms = state
    u = st.initial_grid(STENCIL_GRID, zcomm.device)
    out = {}
    for name, fn, median_s in (
            ("train_step", lambda: step(params, tokens), med_step),
            ("stencil_iter", lambda: st.run_stencil(
                zcomm, STENCIL_GRID, 1, True, u=u), st_ms / 1e3)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        groups = {"gemm": 0.0, "index": 0.0, "reduce": 0.0,
                  "elementwise_copy": 0.0}
        kernels = 0
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                groups[_models_group(ev.key)] += ev.self_device_time_total
                kernels += ev.count
        busy = sum(groups.values())
        out[name] = ({**groups, "busy_us": busy, "kernels": kernels,
                      "idle_share": 1 - busy / (median_s * 1e6)} if busy
                     else "not measured (no device time recorded)")
    log(f"[models] device time, us (torch.profiler): {out}")
    return out


RMA_PVARS = ("dev_rma_tier_rdma", "dev_rma_tier_epoch",
             "dev_rma_fallback_noncontig", "dev_rma_fallback_size",
             "dev_rma_fallback_dtype", "dev_rma_flush", "dev_rma_wire_bytes")


def phase_rma(torch, osu, rma, ring, mpit, dev):
    """The one-sided path: the OSU band (osu_rma.sweep at full size: 7
    sizes x put/get/accumulate x 15 fences of 32 ops, then one
    whole-window op of each kind and a K17 direct put) on a DeviceWin of
    64 MiB f32 a rank over make_mesh((8,), ("x",), dev); then a
    passive-target epoch on rank 7 (lock, 32 puts and a get that must
    see them, flush, an accumulate, unlock) and a strided put that must
    take the epoch tier. The window and every kept get are held against
    a plain replay, bitwise; the kernels' launch counts (zeroed just
    before) and the dev_rma_* pvars are checked. Returns (launches, the
    band's artifact)."""
    before = {k: mpit.pvar(k).read() for k in RMA_PVARS}
    rma.reset_counts()
    keep = []
    t0 = time.perf_counter()
    art = osu.sweep(device=dev, keep=keep)
    win = keep[-1]["win"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1000)
    t, m = R - 1, 4096
    puts = [torch.randn(m, generator=gen, device=dev) for _ in range(32)]
    acc = torch.randn(m, generator=gen, device=dev)
    win.lock(t)
    for i, x in enumerate(puts):
        win.put(x, 0, t, disp=i * m)
    h = win.get(32 * m, 0, t, 0)
    win.flush(t)
    got_epoch = h.value()
    win.accumulate(acc, 0, t, disp=777)
    win.unlock(t)
    strided = torch.arange(1000, dtype=torch.float32, device=dev)
    win.put(strided, 0, 3, disp=11, stride=5)
    win.fence()
    torch.cuda.synchronize()
    ring.check_errors()
    wall = time.perf_counter() - t0
    launches = dict(rma.LAUNCHES)
    plain = dict(rma.PLAIN_CALLS)
    delta = {k: mpit.pvar(k).read() - before[k] for k in RMA_PVARS}
    # the plain replay: band and whole ops, then the epoch and the strided
    # put, on a fresh window
    band = [e for e in keep if e["kind"] in ("put", "get", "acc",
                                             "direct_put")]
    want, gets = osu.replay(band, R, win.n, dev)
    kept = [e["value"] for e in band if e["kind"] == "get"]
    for i, x in enumerate(puts):
        rma.rma_put_ref(x, want, 0, t, i * m)
    want_epoch = rma.rma_get_ref(want, 32 * m, 0, t)
    rma.rma_accumulate_ref(acc, want, 0, t, 777)
    want[3, 11:11 + 5 * 1000:5] = strided
    for g, w in zip(kept + [got_epoch], gets + [want_epoch]):
        _compare(torch, "rma get value", g, w, "i32")
    _compare(torch, "rma window after the path", win.win, want, "i32")
    if not torch.isfinite(win.win).all():
        raise AssertionError("rma window: non-finite values")
    # one launch a contiguous op, none for the strided one
    band_ops = len(osu.SIZES) * 15 * osu.WINDOW
    want_launches = {"rma_put": band_ops + 1 + 32,
                     "rma_get": band_ops + 1 + 1,
                     "rma_accumulate": band_ops + 1 + 1,
                     "rma_accumulate_quant": 0, "direct_put": 1}
    if launches != want_launches or any(plain.values()):
        raise AssertionError(f"rma launches {launches} (expected "
                             f"{want_launches}), plain calls {plain}")
    wire = (3 * 15 * osu.WINDOW * sum(osu.SIZES) + 3 * win.n * 4
            + (32 * m + 32 * m + m) * 4)
    want_delta = {"dev_rma_tier_rdma": 3 * band_ops + 3 + 34,
                  "dev_rma_tier_epoch": 1, "dev_rma_fallback_noncontig": 1,
                  "dev_rma_fallback_size": 0, "dev_rma_fallback_dtype": 0,
                  "dev_rma_flush": 2, "dev_rma_wire_bytes": wire}
    if delta != want_delta:
        raise AssertionError(f"dev_rma_* pvars moved by {delta}, expected "
                             f"{want_delta}")
    log(f"[rma] DeviceWin {R} x {win.n} f32 on {dev}: OSU band "
        f"{len(osu.SIZES)} sizes x put/get/acc x 15 fences of "
        f"{osu.WINDOW}, whole-window put/get/acc/direct_put, a lock/flush/"
        f"unlock epoch and a strided put in {wall:.2f} s; window and "
        f"{len(kept) + 1} gets equal the plain replay; launches {launches}; "
        f"pvars {delta}")
    return launches, art


def phase_moe(torch, moe, a2a, ring, dev):
    """The MoE step bench on the card at 4096 tokens x 4096, all three
    routing shapes, with its kernels' launch counts zeroed before and
    read after; then one hot step held against the plain versions
    (dispatch and combine bitwise) and against x @ W per rank (f32
    products summed in another order: rtol 1e-4, atol 1e-3)."""
    a2a.reset_counts()
    t0 = time.perf_counter()
    art = moe.sweep([MOE_TOKENS], dmodel=MOE_DMODEL, iters=5, device=dev)
    torch.cuda.synchronize()
    ring.check_errors()
    wall = time.perf_counter() - t0
    launches = dict(a2a.LAUNCHES)
    if not all(launches.values()) or any(a2a.PLAIN_CALLS.values()):
        raise AssertionError(f"MoE bench launches {launches}, plain "
                             f"{a2a.PLAIN_CALLS}")
    res = art["results"]
    key = str(MOE_TOKENS * MOE_DMODEL * 4)
    for band in ("moe_step", "moe_step_skew", "moe_step_hot"):
        if not res[band][key] > 0:
            raise AssertionError(f"{band}: no time")
    # one hot step, checked
    gen = torch.Generator(device=dev).manual_seed(SEED + 600)
    W = torch.randn(MOE_DMODEL, MOE_DMODEL, generator=gen, device=dev)
    counts = _moe_counts(moe, "hot")
    xs = [torch.randn(sum(counts[r]), generator=gen, device=dev)
          for r in range(R)]
    toks, h, out = moe.moe_step(xs, W, counts)
    torch.cuda.synchronize()
    ring.check_errors()
    back = [[counts[j][i] for j in range(R)] for i in range(R)]
    for what, got, want in (
            ("dispatch", toks, a2a.hbm_alltoallv_ref(xs, counts)),
            ("combine", out, a2a.hbm_alltoallv_ref(h, back))):
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"MoE step {what}: differs from the "
                                     f"plain version")
    err = 0.0
    for x, o in zip(xs, out):
        want = torch.matmul(x.view(-1, MOE_DMODEL), W).view(-1)
        if o.shape != want.shape or not torch.isfinite(o).all() or \
                not torch.allclose(o, want, rtol=1e-4, atol=1e-3):
            raise AssertionError("MoE step: combine(expert(dispatch(x))) "
                                 "is not x @ W")
        err = max(err, (o - want).abs().max().item())
    log(f"[moe] bench.moe.sweep([{MOE_TOKENS}], dmodel={MOE_DMODEL}) in "
        f"{wall:.2f} s: step us uniform {res['moe_step'][key]:.1f}, skew "
        f"{res['moe_step_skew'][key]:.1f}, hot {res['moe_step_hot'][key]:.1f}; "
        f"uniform alltoall effbw {res['dev_alltoall_effbw'][key]:.1f} GB/s "
        f"((p-1)/p*m/t); tiers {art['a2a_tiers']}; wire bytes "
        f"{art['wire_bytes']}; launches {launches}; hot step checked "
        f"(dispatch and combine bitwise, x @ W max abs err {err:.3g})")
    return art


def phase_moe_profile(torch, moe, art, dev):
    """One MoE step of each routing shape under torch.profiler: device
    time by kernel group, and the idle share of the sweep's unprofiled
    median step (1 - busy / median). Run last: the profiler slows the
    host side of every later call in the process."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 800)
    W = torch.randn(MOE_DMODEL, MOE_DMODEL, generator=gen, device=dev)
    key = str(MOE_TOKENS * MOE_DMODEL * 4)
    split = {}
    for band, shape in moe.SHAPES.items():
        c = _moe_counts(moe, shape)
        b = moe.breakdown([torch.randn(sum(c[r]), generator=gen, device=dev)
                           for r in range(R)], W, c)
        if b:
            b["idle_share"] = 1 - b["busy_us"] / art["results"][band][key]
        split[shape] = b or "not measured (no device activity profiled)"
    log(f"[moe] device time a step, us (torch.profiler): {split}")
    return split


def phase_rma_profile(torch, osu, dev):
    """One fence of 32 ops of each kind at 1 KiB and 4 MiB on a DeviceWin
    of 64 MiB f32 a rank, under torch.profiler: device time by kernel
    group and the idle share of the fence. Run last, as the MoE
    profile."""
    from mvapich2_tpu_torch.parallel import MeshComm, make_mesh
    from mvapich2_tpu_torch.rma import DeviceWin
    win = DeviceWin(MeshComm(make_mesh((R,), ("x",), dev)), N)
    split = {}
    for kind in ("put", "get", "acc"):
        for size in (1 << 10, 4 << 20):
            b = osu.breakdown(win, kind, size)
            split[f"{kind} {size}"] = b or "not measured (no device " \
                                            "activity profiled)"
    log(f"[rma] device time a fence of {osu.WINDOW} ops, us "
        f"(torch.profiler): {split}")
    return split


def phase_rma_host_profile(torch, dev, top=15):
    """The host side of one fence of 32 puts and 32 gets at 1 KiB (rank 0
    to rank 7 of a DeviceWin of 64 MiB f32 a rank), after a warm-up
    fence: perf_counter splits of the enqueue (64 calls) and of the fence
    (tier plan, launches and the completion wave), median of 5; then one
    fence under cProfile and its entries with the most cumulative time.
    Run before torch.profiler, which slows every later host call."""
    import cProfile
    import io
    import pstats
    from mvapich2_tpu_torch.parallel import MeshComm, make_mesh
    from mvapich2_tpu_torch.rma import DeviceWin
    win = DeviceWin(MeshComm(make_mesh((R,), ("x",), dev)), N)
    src = torch.ones(256, device=dev)

    def fence():
        t0 = time.perf_counter()
        for _ in range(32):
            win.put(src, 0, R - 1)
        for _ in range(32):
            win.get(256, 0, R - 1)
        t1 = time.perf_counter()
        win.fence()
        return t1 - t0, time.perf_counter() - t1

    fence()
    splits = [fence() for _ in range(5)]
    enq = statistics.median(a for a, _ in splits) * 1e6
    fen = statistics.median(b for _, b in splits) * 1e6
    prof = cProfile.Profile()
    prof.enable()
    fence()
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(top)
    lines = [ln for ln in text.getvalue().splitlines() if ln.strip()]
    log(f"[rma] host time of one fence of 32 puts + 32 gets at 1 KiB: "
        f"enqueue {enq:.1f} us, fence {fen:.1f} us, "
        f"{(enq + fen) / 64:.2f} us an op (median of 5); cProfile of one "
        f"fence, top {top} by cumulative time:")
    for ln in lines:
        log(f"[rma]   {ln}")
    return {"enqueue_us": enq, "fence_us": fen,
            "per_op_us": (enq + fen) / 64, "cprofile_top": lines}


TRACE_CALLS = 6                    # allreduces a traced program runs a size
TRACE_WARM = 1                     # of them left out of the medians
SPLIT_WARM, SPLIT_CALLS = 2, 5     # calls of the host split
HERE = os.path.dirname(os.path.abspath(__file__))


def _read_dumps(d):
    """rank -> its event rows, from the trace-r<rank>.json dumps in d."""
    out = {}
    for f in sorted(os.listdir(d)):
        if f.startswith("trace-r") and f.endswith(".json"):
            with open(os.path.join(d, f)) as fh:
                snap = json.load(fh)
            if snap["clock"] != "monotonic":
                raise AssertionError(f"[trace] {f}: clock {snap['clock']}")
            out[snap["rank"]] = snap["events"]
    return out


def _check_spans(what, dumps):
    """Every B/E span of every rank balanced, in order."""
    for rank, events in dumps.items():
        depth = collections.Counter()
        for _, layer, name, ph, _ in events:
            if ph in "BE":
                depth[(layer, name)] += 1 if ph == "B" else -1
                if depth[(layer, name)] < 0:
                    raise AssertionError(f"[trace] {what} rank {rank}: E of "
                                         f"{layer}/{name} with no open B")
        if any(depth.values()):
            raise AssertionError(f"[trace] {what} rank {rank}: spans left "
                                 f"open {dict(+depth)}")


TRACE_PVARS = ("dev_coll_tier_vmem", "dev_coll_tier_hbm",
               "dev_coll_tier_quant", "coll_level_chip", "lat_dev_vmem",
               "lat_dev_hbm", "lat_dev_quant", "lat_dev_slot",
               "lat_rma_flush")


def _check_program(mpit, what, dumps, nranks, before, calls):
    """A traced program's dumps against the pvars it moved: a dump a rank;
    every span balanced; ``calls`` dev_allreduce spans a rank, whose B
    tiers are the tiers the tier pvars counted (the slot channel's, the
    calls coll_level_chip counted) and the lat_dev_<tier> records."""
    if sorted(dumps) != list(range(nranks)):
        raise AssertionError(f"[trace] {what}: dumps of ranks "
                             f"{sorted(dumps)}, expected {nranks}")
    _check_spans(what, dumps)
    delta = {k: mpit.pvar(k).read() - before[k] for k in TRACE_PVARS}
    tiers = collections.Counter(
        ev[4]["tier"] for evs in dumps.values() for ev in evs
        if ev[2] == "dev_allreduce" and ev[3] == "B")
    if not calls:
        return delta
    if sum(tiers.values()) != nranks * calls:
        raise AssertionError(f"[trace] {what}: {sum(tiers.values())} "
                             f"dev_allreduce spans, expected "
                             f"{nranks * calls}")
    counted = ({"slot": delta["coll_level_chip"]} if "slot" in tiers else
               {t: delta[f"dev_coll_tier_{t}"]
                for t in ("vmem", "hbm", "quant")})
    if tiers != +collections.Counter(counted):
        raise AssertionError(f"[trace] {what}: span tiers {dict(tiers)}, "
                             f"tier pvars {counted}")
    hists = {t: delta[f"lat_dev_{t}"] for t in ("vmem", "hbm", "quant",
                                               "slot")}
    if tiers != +collections.Counter(hists):
        raise AssertionError(f"[trace] {what}: span tiers {dict(tiers)}, "
                             f"histogram records {hists}")
    return delta


class _TimedBarrier:
    """A threading.Barrier whose waits append (thread, "wait", t0, t1) to
    ``marks`` (the [trace] host split)."""

    def __init__(self, barrier, marks):
        self.barrier, self.marks = barrier, marks

    def wait(self):
        t0 = time.perf_counter()
        try:
            return self.barrier.wait()
        finally:
            self.marks.append((threading.current_thread().name, "wait", t0,
                               time.perf_counter()))

    def abort(self):
        self.barrier.abort()


def _leader_classes(coll_dev):
    return (coll_dev.HBMSlotChannel, coll_dev.DeviceCollChannel,
            coll_dev.DeviceFoldChannel)


def _host_split(torch, mvt, coll_dev, inputs, mesh):
    """One 64 MiB f32 allreduce's host time, by perf_counter wrappers set
    up here (the package has no spans there): the app's call, each wait
    at the rendezvous barrier and the leader's program. Split a call into
    deposit (call to first wait), first wait, leader (rank 0), second
    wait and delivery (second wait to return); medians over SPLIT_CALLS
    calls after SPLIT_WARM, for rank 0 and the other ranks pooled."""
    marks = []

    class Timed(coll_dev._Rendezvous):
        def __init__(self, size):
            super().__init__(size)
            self.barrier = _TimedBarrier(self.barrier, marks)

    def timed(fn):
        def leader(self, *a):
            t0 = time.perf_counter()
            try:
                return fn(self, *a)
            finally:
                marks.append((threading.current_thread().name, "leader", t0,
                              time.perf_counter()))
        return leader

    def app(comm):
        stream = torch.cuda.current_stream()
        for _ in range(SPLIT_WARM + SPLIT_CALLS):
            t0 = time.perf_counter()
            comm.allreduce(inputs[comm.rank])
            marks.append((threading.current_thread().name, "call", t0,
                          time.perf_counter()))
            stream.synchronize()

    saved = {cls: cls.__dict__["_leader"] for cls in _leader_classes(coll_dev)}
    coll_dev._Rendezvous, rv = Timed, coll_dev._Rendezvous
    try:
        for cls, fn in saved.items():
            cls._leader = timed(fn)
        mvt.run_ranks(R, app, device_mesh=mesh)
    finally:
        coll_dev._Rendezvous = rv
        for cls, fn in saved.items():
            cls._leader = fn
    per = collections.defaultdict(list)      # thread -> [split of a call]
    cur = collections.defaultdict(list)      # thread -> marks of its call
    for thread, kind, t0, t1 in marks:       # a thread's marks in order
        if kind != "call":
            cur[thread].append((kind, t0, t1))
            continue
        inside = cur.pop(thread)
        (w1a, w1b), (w2a, w2b) = [(a, b) for k, a, b in inside
                                  if k == "wait"]
        per[thread].append({"deposit": w1a - t0, "wait_1": w1b - w1a,
                            "leader": sum(b - a for k, a, b in inside
                                          if k == "leader"),
                            "wait_2": w2b - w2a, "delivery": t1 - w2b,
                            "call": t1 - t0})
    split = {}
    for who, threads in (("rank_0", ["rank-0"]),
                         ("ranks_1_7", [f"rank-{r}" for r in range(1, R)])):
        calls = [c for t in threads for c in per[t][SPLIT_WARM:]]
        split[who] = {k: statistics.median(c[k] for c in calls) * 1e6
                      for k in calls[0]}
    return split


def phase_trace(torch, np, mvt, mpit, cfg, smi, inputs, dev):
    """The trace and metric hooks on the main paths (see the module
    docstring, phase 12). Returns the phase's figures."""
    from mvapich2_tpu_torch.coll import device as coll_dev
    from mvapich2_tpu_torch.ops import hbm, ici, ring
    from mvapich2_tpu_torch.parallel import MeshComm
    from mvapich2_tpu_torch.rma import DeviceWin
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 900)
    small = [_data(torch, np, rng, (SMALL_MESH,), "f32", dev)
             for _ in range(R)]
    # CUDA events on the leader's stream: after its deposit waits, around
    # each kernel wrapper it calls, after its program; one row a call
    starts, kernels, calls_ev = [], [], []

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream())
        return ev

    def wait_deposits(device, events):
        wait_deposits.real(device, events)
        starts.append(event())
    wait_deposits.real = coll_dev._wait_deposits

    def card_timed(fn):
        def leader(self, *a):
            out = fn(self, *a)
            calls_ev.append((starts.pop(), event(), kernels[:]))
            del kernels[:]
            return out
        return leader

    def kernel_timed(fn):
        def wrapper(*a, **kw):
            ev = event()
            out = fn(*a, **kw)
            kernels.append((ev, event()))
            return out
        return wrapper
    wrappers = [(hbm, "hbm_slot_allreduce"), (ici, "hbm_ring_all_reduce"),
                (ici, "hbm_ring_reduce_scatter"),
                (ici, "hbm_ring_all_gather"), (ring, "ring_all_reduce")]

    def ar_app(*sizes):
        def app(comm):
            stream = torch.cuda.current_stream()
            for bufs in sizes:
                for _ in range(TRACE_CALLS):
                    comm.allreduce(bufs[comm.rank])
                    stream.synchronize()
        return app

    def rma_app(comm):
        win = DeviceWin(MeshComm(mvt.make_mesh((R,), ("x",), dev)), N)
        m = N // 64                        # 1 MiB f32 an op
        src = torch.arange(m, dtype=torch.float32, device=dev)
        win.fence()
        win.put(src, 0, R - 1, 0)
        h = win.get(m, 3, R - 1, 0)
        win.accumulate(src, 1, 5, m)
        win.fence()
        win.lock(4)
        win.put(src * 2, 2, 4, 0)
        win.flush(4)
        win.unlock(4)
        torch.cuda.current_stream().synchronize()
        if not (torch.equal(h.value(), src)
                and torch.equal(win.win[4, :m], src * 2)
                and torch.equal(win.win[5, m:2 * m], src)):
            raise AssertionError("[trace] DeviceWin epoch: wrong window")

    mesh1 = mvt.make_mesh((R,), ("x",), dev)
    programs = (   # name, ranks, app, run_ranks arguments, calls a rank
        ("slot", R, ar_app(inputs), {}, TRACE_CALLS),
        ("mesh", R, ar_app(inputs, small), dict(device_mesh=mesh1),
         2 * TRACE_CALLS),
        ("fold", R, ar_app(inputs),
         dict(device_mesh=mvt.make_mesh((4,), ("x",), dev)), TRACE_CALLS),
        ("mesh2d", R, ar_app(inputs),
         dict(device_mesh=mvt.make_mesh((2, 4), ("x", "y"), dev)),
         TRACE_CALLS),
        ("rma", 1, rma_app, dict(device=dev), 0))
    root = tempfile.mkdtemp(prefix="mv2t-trace-")
    dirs, spans, card, kern, deltas = [], {}, {}, {}, {}
    saved = {cls: cls.__dict__["_leader"] for cls in _leader_classes(coll_dev)}
    saved_k = {(m, f): getattr(m, f) for m, f in wrappers}
    try:
        coll_dev._wait_deposits = wait_deposits
        for cls, fn in saved.items():
            cls._leader = card_timed(fn)
        for (m, f), fn in saved_k.items():
            setattr(m, f, kernel_timed(fn))
        for name, nranks, app, kw, calls in programs:
            d = os.path.join(root, name)
            dirs.append(d)
            before = {k: mpit.pvar(k).read() for k in TRACE_PVARS}
            del calls_ev[:]
            cfg.set("TRACE", True)
            cfg.set("TRACE_DIR", d)
            try:
                mvt.run_ranks(nranks, app, **kw)
            finally:
                cfg.set("TRACE", False)
                cfg.set("TRACE_DIR", "")
            torch.cuda.synchronize()
            dumps = _read_dumps(d)
            deltas[name] = _check_program(mpit, name, dumps, nranks, before,
                                          calls)
            us = [ev[4]["us"] for ev in dumps[0]
                  if ev[2] == "dev_allreduce" and ev[3] == "E"]
            window = [a.elapsed_time(b) * 1e3 for a, b, _ in calls_ev]
            in_k = [sum(a.elapsed_time(b) * 1e3 for a, b in ks)
                    for _, _, ks in calls_ev]
            for part, lo in ((name, 0), (f"{name}_64KiB", TRACE_CALLS)):
                if lo < len(us):
                    keep = slice(lo + TRACE_WARM, lo + TRACE_CALLS)
                    spans[part] = statistics.median(us[keep])
                    card[part] = statistics.median(window[keep])
                    kern[part] = statistics.median(in_k[keep])
    finally:
        coll_dev._wait_deposits = wait_deposits.real
        for cls, fn in saved.items():
            cls._leader = fn
        for (m, f), fn in saved_k.items():
            setattr(m, f, fn)
    if deltas["rma"]["lat_rma_flush"] != 2:
        raise AssertionError(f"[trace] rma: lat_rma_flush moved by "
                             f"{deltas['rma']['lat_rma_flush']}, expected 2 "
                             f"(the fence and the flush)")
    rma_ev = [ev[2] for ev in _read_dumps(dirs[-1])[0]]
    want_rma = ["rma_fence", "rma_put", "rma_get", "rma_acc", "rma_fence",
                "rma_lock", "rma_flush", "rma_put", "rma_flush",
                "rma_unlock"]
    if rma_ev != want_rma:
        raise AssertionError(f"[trace] rma events {rma_ev}, expected "
                             f"{want_rma}")
    conform = subprocess.run(
        [sys.executable, os.path.join(HERE, "bin", "mv2tconform"), *dirs],
        capture_output=True, text=True, timeout=120)
    verdict = (conform.stdout.strip().splitlines() or [""])[-1]
    if conform.returncode != 0:
        raise AssertionError(f"[trace] bin/mv2tconform exited "
                             f"{conform.returncode}: {conform.stdout[-3000:]}"
                             f"{conform.stderr[-2000:]}")
    log(f"[trace] {smi}: five traced programs, every rank dumped, spans "
        f"balanced, span tiers = tier pvars = lat_dev_* records; "
        f"bin/mv2tconform exit 0 ({verdict})")
    for part in spans:
        path, _, small_part = part.partition("_")
        log(f"[trace] {smi}: {path} {'64 KiB' if small_part else '64 MiB'} "
            f"f32 allreduce: dev_allreduce span median {spans[part]:.1f} us; "
            f"the leader's kernels {kern[part]:.1f} us of card time (CUDA "
            f"events around each kernel wrapper it calls, its enqueue "
            f"included), its window {card[part]:.1f} us (events after its "
            f"deposit waits and after its program: the kernels and the "
            f"card's idle gaps while it enqueues); calls "
            f"{TRACE_WARM + 1}-{TRACE_CALLS}")
    # the cost of tracing: the slot allreduce untraced and traced, in turns
    lat = {False: [], True: []}
    runs = {False: [], True: []}
    for traced in (False, True, True, False) * 2:
        cfg.set("TRACE", traced)
        try:
            res = mvt.run_ranks(R, lambda comm: _ar_lat(
                comm, torch, inputs[comm.rank], 2, 10))
        finally:
            cfg.set("TRACE", False)
        lat[traced] += res[0]
        runs[traced].append(statistics.median(res[0]) * 1e3)
    off, on = (statistics.median(lat[k]) * 1e3 for k in (False, True))
    log(f"[trace] {smi}: e2e slot allreduce 8 x 64 MiB f32, median of 40 "
        f"(4 runs of 10 after 2, in turns): untraced {off:.4f} ms, traced "
        f"{on:.4f} ms ({(on - off) * 1e3:+.1f} us a call); run medians "
        f"untraced {[round(v, 4) for v in runs[False]]}, traced "
        f"{[round(v, 4) for v in runs[True]]}")
    split = {"slot": _host_split(torch, mvt, coll_dev, inputs, None),
             "mesh": _host_split(torch, mvt, coll_dev, inputs, mesh1)}
    for path, sp in split.items():
        for who, parts in sp.items():
            log(f"[trace] {smi}: host split of one {path} 64 MiB allreduce, "
                f"{who}, us (median of {SPLIT_CALLS}): " + ", ".join(
                    f"{k} {v:.1f}" for k, v in parts.items()))
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    took = time.perf_counter() - t_phase
    log(f"[trace] phase took {took:.2f} s")
    return {"span_median_us": spans, "leader_kernels_us": kern,
            "leader_window_us": card,
            "e2e_slot_ms": {"untraced": off, "traced": on,
                            "run_medians": {"untraced": runs[False],
                                            "traced": runs[True]}},
            "host_split_us": split, "mv2tconform": verdict,
            "phase_s": took}


def phase_times(torch, hbm, timing, info, smi, inputs, lat, launches,
                full_err):
    """K1 and K2 at the main path's 8 x 64 MiB f32, by CUDA events and by
    card time (``_queued_ms``): K1 over the 8 deposits in place (the main
    path's), beside the parent's leader (``torch.stack`` then K1), K1 on
    the stacked planar and interleaved slots, its plain version and two
    library forms (``torch.sum`` of the stacked tensor, and
    ``torch.stack(deposits).sum(0)``, which starts from the deposits as
    K1 does); K2 beside sum + expand; the e2e allreduce latency."""
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

    def both(fn, **kw):
        return timing.time_ms(fn, **kw), _queued_ms(torch, fn)

    k1_ms, k1_card = both(lambda: hbm.hbm_slot_allreduce(inputs))
    stack_k1_ms, stack_k1_card = both(lambda: hbm.fused_reduce_to_slot(
        torch.stack(inputs).reshape(R, M_FULL, 128)))
    k1p_ms = timing.time_ms(lambda: hbm.fused_reduce_to_slot(x))
    k1i_ms = timing.time_ms(
        lambda: hbm.fused_reduce_to_slot(xi, layout="interleaved"))
    k1_plain = timing.time_ms(lambda: hbm.hbm_slot_allreduce_ref(inputs))
    k1_lib, k1_lib_card = both(lambda: torch.sum(x, 0))
    k1_lib2, k1_lib2_card = both(lambda: torch.stack(inputs).sum(0))
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
         "bound_ms": k1_b, "bound_by": k1_by, "library_ms": k1_lib,
         "card_ms": k1_card, "library_card_ms": k1_lib_card,
         "library_stack_sum_ms": k1_lib2,
         "library_stack_sum_card_ms": k1_lib2_card,
         "stack_then_k1_ms": stack_k1_ms,
         "stack_then_k1_card_ms": stack_k1_card,
         "strided_planar_ms": k1p_ms, "strided_interleaved_ms": k1i_ms},
        {"name": "fused_allreduce", "route": "cuda",
         "source": "mvapich2_tpu_torch/csrc/hbm_slot.cu",
         "replaces": "mvapich2_tpu/ops/pallas_hbm.py:124",
         "launches": launches["fused_allreduce"],
         "max_abs_err": full_err["K2"], "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_b, "bound_by": k2_by, "library_ms": None},
    ]
    extra = {"k2_two_call_ms": k2_two_call, "stack_ms": stack_ms,
             "e2e_allreduce_ms": e2e * 1e3,
             "e2e_allreduce_ms_all": [t * 1e3 for t in lat[0]],
             "e2e_small_allreduce_ms": e2e_small * 1e3,
             "e2e_small_allreduce_ms_all": [t * 1e3 for t in lat[1]],
             "device_share_of_e2e": k1_card / (e2e * 1e3),
             "e2e_effbw_GBps": 2 * R * m / e2e / 1e9,
             "k1_actual_GBps": (R + 1) * m / (k1_ms * 1e-3) / 1e9,
             "k2_actual_GBps": 2 * R * m / (k2_ms * 1e-3) / 1e9,
             "hbm_bw_GBps": info.hbm_bw_gbps}
    log(f"[times] {smi}: K1 over the deposits {k1_ms:.4f} ms, card "
        f"{k1_card:.4f} ({k1_b / k1_card:.1%} of the bound {k1_b:.4f}); "
        f"stack then K1 (the parent's leader) {stack_k1_ms:.4f}, card "
        f"{stack_k1_card:.4f}; K1 on stacked slots planar {k1p_ms:.4f}, "
        f"interleaved {k1i_ms:.4f}; plain {k1_plain:.4f}; torch.sum of "
        f"the stacked {k1_lib:.4f}, card {k1_lib_card:.4f}; "
        f"torch.stack(deposits).sum(0) {k1_lib2:.4f}, card "
        f"{k1_lib2_card:.4f}")
    log(f"[times] {smi}: K2 {k2_ms:.4f} ms (bound {k2_b:.4f}, plain "
        f"{k2_plain:.4f}, two-call sum+expand {k2_two_call:.4f}); stack "
        f"{stack_ms:.4f} ms; e2e allreduce {e2e * 1e3:.4f} ms = "
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
    events: its time, its plain version's, its bound (each input read
    once, each output written once, over the memory rate; the adds over
    the f32 peak), the bytes its schedule moves through device memory
    over the same rate, and two library calls: ``library_ms`` writes
    every rank's copy of the result, as the kernel does (the sum or the
    concatenation, then ``.expand(p, -1).contiguous()``), and
    ``library_one_copy_ms`` writes one (the sum or the concatenation
    alone). K6 and K7 also carry their card time and the library form's
    (``card_ms``, ``library_card_ms``) and both at 64 KiB and 4 MiB
    (``sizes``, from ``direct_ring_times``)."""
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
        lib_ms = timing.time_ms(lambda: lib().expand(p, -1).contiguous())
        lib_one_ms = timing.time_ms(lib)
        b, by = bound(n_in + out_elems * 4, flops)
        ring.check_errors()
        return {"name": name, "route": "cuda",
                "source": "mvapich2_tpu_torch/csrc/ring.cu",
                "replaces": src_line, "launches": launches[name],
                "max_abs_err": full_err[kern], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                "library_ms": lib_ms, "library_one_copy_ms": lib_one_ms,
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
              2 * p * m, "2pm: one direct fold, the bound"),
        entry("hbm_ring_all_gather", "K5", "mvapich2_tpu/ops/pallas_ici.py:545",
              ag, lambda: ici.hbm_ring_all_gather(ag),
              lambda: ici.hbm_ring_all_gather_ref(ag),
              lambda: torch.cat(ag), p * p * AG_MESH, 0,
              p * ma + p * p * ma,
              "pm + p*pm: one direct copy, the bound"),
        entry("ring_all_reduce", "K6", "mvapich2_tpu/ops/pallas_ring.py:214",
              small, lambda: ring.ring_all_reduce(small),
              lambda: ring.ring_all_reduce_ref(small),
              lambda: torch.stack(small).sum(0), p * SMALL_MESH,
              (p - 1) * SMALL_MESH, 2 * p * ms_,
              "2pm: one direct fold, the bound"),
        entry("ring_all_gather", "K7", "mvapich2_tpu/ops/pallas_ring.py:114",
              small, lambda: ring.ring_all_gather(small),
              lambda: ring.ring_all_gather_ref(small),
              lambda: torch.cat(small), p * p * SMALL_MESH, 0,
              p * ms_ + p * p * ms_,
              "pm + p*pm: one direct copy, the bound"),
    ]
    k3 = kernels[0]
    k3["card_ms"] = _queued_ms(torch, lambda: ici.hbm_ring_all_reduce(inputs))
    k3["library_card_ms"] = _queued_ms(
        torch, lambda: torch.stack(inputs).sum(0).expand(p, -1).contiguous())
    k3["library_one_copy_card_ms"] = _queued_ms(
        torch, lambda: torch.stack(inputs).sum(0))
    k5 = kernels[1]
    k5["card_ms"] = _queued_ms(torch, lambda: ici.hbm_ring_all_gather(ag))
    k5["library_card_ms"] = _queued_ms(
        torch, lambda: torch.cat(ag).expand(p, -1).contiguous())
    k5["mesh2d_phases"] = k5_phase_times(torch, ici, timing, bw, inputs)
    direct = direct_ring_times(torch, np, ring, timing, bw, dev)
    for row in kernels[2:]:
        d = direct[row["name"]]
        row["card_ms"] = d["64KiB"]["card_ms"]
        row["library_card_ms"] = d["64KiB"]["library_card_ms"]
        row["sizes"] = d
    lat, lat_small = mesh_lat
    extra = {"mesh_e2e_allreduce_ms": statistics.median(lat) * 1e3,
             "mesh_e2e_allreduce_ms_all": [t * 1e3 for t in lat],
             "mesh_e2e_small_allreduce_ms": statistics.median(lat_small) * 1e3,
             "mesh_e2e_small_allreduce_ms_all": [t * 1e3 for t in lat_small],
             "mesh_e2e_effbw_GBps": 2 * R * m / statistics.median(lat) / 1e9,
             "k6_host_profile": direct["k6_host_profile"]}
    log(f"[times] K3 8 x 64 MiB f32: card {k3['card_ms']:.4f} ms, library "
        f"every rank's copy card {k3['library_card_ms']:.4f}, one copy card "
        f"{k3['library_one_copy_card_ms']:.4f}; K6 8 x 64 KiB f32: card "
        f"{kernels[2]['card_ms']:.4f} ms")
    log(f"[times] K5 8 x 1 MiB f32: card {k5['card_ms']:.4f} ms, library "
        f"every rank's copy card {k5['library_card_ms']:.4f}; (2, 4) "
        "allreduce phases: " + "; ".join(
            f"{ph}: " + ", ".join(f"{k} {v:.4f}" for k, v in r.items()
                                  if k != "shape")
            for ph, r in k5["mesh2d_phases"].items()))
    log("[times] ring kernels " + "; ".join(
        f"{k['name']}: {k['ms']:.4f} ms (bound {k['bound_ms']:.4f}, schedule "
        f"bound {k['schedule_bound_ms']:.4f}, plain {k['plain_ms']:.4f}, "
        f"library, every rank's copy {k['library_ms']:.4f}, one copy "
        f"{k['library_one_copy_ms']:.4f}), launches {k['launches']}"
        for k in kernels))
    log(f"[times] mesh e2e allreduce 64 MiB {extra['mesh_e2e_allreduce_ms']:.4f}"
        f" ms = {extra['mesh_e2e_effbw_GBps']:.1f} GB/s effbw (2*R*m/t); "
        f"4 KiB {extra['mesh_e2e_small_allreduce_ms']:.4f} ms")
    return kernels, extra


def k5_phase_times(torch, ici, timing, bw, inputs):
    """K5's two phases of the (2, 4) mesh's 64 MiB f32 allreduce (AG-y:
    2 lines of 4 shards of N/8; AG-x: 4 lines of 2 shards of N/2), fed
    the kernels' own RS-x and RS-y outputs as the path does
    (``ici._axis_phase``), by CUDA events and by card time, each beside
    its bound (each input read once, each output written once) and the
    library form that writes every rank's copy (the line's shards
    stacked, then expanded to the p rows of the line)."""
    axes = (("x", 2), ("y", 4))
    y = list(inputs)
    for k in (0, 1):
        y = ici._axis_phase(y, axes, k, lambda sh, lines:
                            ici.hbm_ring_reduce_scatter(sh, lines=lines))
    out = {}
    for ph, k in (("AG-y", 1), ("AG-x", 0)):
        size = axes[k][1]
        lines = R // size
        m = y[0].numel()
        order = torch.arange(R).reshape(2, 4).movedim(k, -1).reshape(-1) \
            .tolist()
        sh = [y[i] for i in order]

        def kern(sh=sh, lines=lines):
            return ici.hbm_ring_all_gather(sh, lines=lines)

        def lib(sh=sh, lines=lines, size=size, m=m):
            return torch.stack(sh).view(lines, 1, size * m) \
                .expand(lines, size, size * m).contiguous()

        if not torch.equal(kern(), lib().view(R, size * m)):
            raise AssertionError(f"K5 {ph}: kernel and library disagree")
        out[ph] = {"shape": f"{lines} lines of {size}, {m} f32 a shard",
                   "ms": timing.time_ms(kern),
                   "card_ms": _queued_ms(torch, kern),
                   "bound_ms": (R * m + R * size * m) * 4 / bw * 1e3,
                   "library_ms": timing.time_ms(lib),
                   "library_card_ms": _queued_ms(torch, lib)}
        y = ici._axis_phase(y, axes, k, lambda s, ln:
                            ici.hbm_ring_all_gather(s, lines=ln))
    return out


def phase_rs_times(torch, ici, ring, timing, info, inputs, launches,
                   full_err, lat):
    """K4 and K8 at the main path's 8 x 64 MiB f32, by CUDA events, each
    beside its bound, its schedule bound, its plain version and the
    library call (K4: torch.stack(x).sum(0), whose blocks are the ranks'
    outputs; K8: torch.stack by partner index); K4 also as the (2, 4)
    mesh's RS-x phase (4 lines of 2), and K4 and its library call in both
    shapes by card time too (``_queued_ms``). Then the host-clock latency
    of the fold and (2, 4) allreduces of 64 MiB beside the 1-D mesh
    call."""
    bw = info.hbm_bw_gbps * 1e9
    p, m = R, N * 4

    def bound(nbytes, flops):
        tb, to = nbytes / bw * 1e3, flops / (F32_PEAK_TFLOPS * 1e12) * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    part = list(range(p))
    part[2], part[5] = 5, 2
    rsx = [inputs[i] for i in (0, 4, 1, 5, 2, 6, 3, 7)]
    k4_ms = timing.time_ms(lambda: ici.hbm_ring_reduce_scatter(inputs))
    k4_plain = timing.time_ms(
        lambda: ici.hbm_ring_reduce_scatter_ref(inputs), warmup=1, iters=5)
    k4_lib = timing.time_ms(lambda: torch.stack(inputs).sum(0))
    k4x_ms = timing.time_ms(
        lambda: ici.hbm_ring_reduce_scatter(rsx, lines=4))
    k4x_plain = timing.time_ms(
        lambda: ici.hbm_ring_reduce_scatter_ref(rsx, lines=4), warmup=1,
        iters=5)
    k4x_lib = timing.time_ms(
        lambda: torch.stack(inputs).reshape(2, 4, N).sum(0))
    k4_card = _queued_ms(torch, lambda: ici.hbm_ring_reduce_scatter(inputs))
    k4_lib_card = _queued_ms(torch, lambda: torch.stack(inputs).sum(0))
    k4x_card = _queued_ms(
        torch, lambda: ici.hbm_ring_reduce_scatter(rsx, lines=4))
    k4x_lib_card = _queued_ms(
        torch, lambda: torch.stack(inputs).reshape(2, 4, N).sum(0))
    k8_ms = timing.time_ms(lambda: ici.remote_sendrecv(inputs, 2, 5))
    k8_plain = timing.time_ms(lambda: ici.remote_sendrecv_ref(inputs, 2, 5))
    k8_lib = timing.time_ms(lambda: torch.stack([inputs[j] for j in part]))
    k8_card = _queued_ms(torch, lambda: ici.remote_sendrecv(inputs, 2, 5))
    k8_lib_card = _queued_ms(
        torch, lambda: torch.stack([inputs[j] for j in part]))
    ring.check_errors()
    # K4: read p inputs, write p blocks of m/p; (p-1) adds an element of
    # the folded array. The RS-x phase: 4 pairs, each output half a shard
    k4_b, k4_by = bound(p * m + m, (p - 1) * N)
    k4x_b, k4x_by = bound(p * m + p * m // 2, 4 * N)
    k8_b, k8_by = bound(2 * p * m, 0)
    kernels = [
        {"name": "hbm_ring_reduce_scatter", "route": "cuda",
         "source": "mvapich2_tpu_torch/csrc/ring.cu",
         "replaces": "mvapich2_tpu/ops/pallas_ici.py:580",
         "launches": launches["hbm_ring_reduce_scatter"],
         "max_abs_err": full_err["K4"], "ms": k4_ms, "plain_ms": k4_plain,
         "bound_ms": k4_b, "bound_by": k4_by, "library_ms": k4_lib,
         "schedule_bound_ms": k4_b,
         "schedule_bytes": "= bound: one direct fold, every input read "
                           "once, every block written once",
         "card_ms": k4_card, "library_card_ms": k4_lib_card},
        {"name": "remote_sendrecv", "route": "cuda",
         "source": "mvapich2_tpu_torch/csrc/ring.cu",
         "replaces": "mvapich2_tpu/ops/pallas_ici.py:642",
         "launches": launches["remote_sendrecv"],
         "max_abs_err": full_err["K8"], "ms": k8_ms, "plain_ms": k8_plain,
         "bound_ms": k8_b, "bound_by": k8_by, "library_ms": k8_lib,
         "schedule_bound_ms": k8_b,
         "schedule_bytes": "2pm: every shard read once, every row written "
                           "once",
         "card_ms": k8_card, "library_card_ms": k8_lib_card},
    ]
    med = {k: statistics.median(v) * 1e3 for k, v in lat.items()}
    extra = {"k4_rs_x_ms": k4x_ms, "k4_rs_x_plain_ms": k4x_plain,
             "k4_rs_x_library_ms": k4x_lib, "k4_rs_x_bound_ms": k4x_b,
             "k4_rs_x_card_ms": k4x_card,
             "k4_rs_x_library_card_ms": k4x_lib_card,
             **{f"{k}_e2e_allreduce_ms": v for k, v in med.items()},
             **{f"{k}_e2e_allreduce_ms_all": [t * 1e3 for t in v]
                for k, v in lat.items()}}
    log("[times] " + "; ".join(
        f"{k['name']}: {k['ms']:.4f} ms (bound {k['bound_ms']:.4f}, "
        f"schedule bound {k['schedule_bound_ms']:.4f}, plain "
        f"{k['plain_ms']:.4f}, library {k['library_ms']:.4f}), launches "
        f"{k['launches']}" for k in kernels)
        + f"; K4 card {k4_card:.4f} ms ({k4_b / k4_card:.1%} of the "
        f"bound), library card {k4_lib_card:.4f}; K4 as the (2, 4) RS-x "
        f"phase {k4x_ms:.4f} ms, card {k4x_card:.4f} ({k4x_b / k4x_card:.1%}"
        f" of the bound {k4x_b:.4f}), plain {k4x_plain:.4f}, library "
        f"{k4x_lib:.4f}, card {k4x_lib_card:.4f}; K8 card {k8_card:.4f} "
        f"ms ({k8_b / k8_card:.1%} of the bound), torch.stack by partner "
        f"card {k8_lib_card:.4f}")
    log("[times] e2e allreduce 64 MiB f32 (median): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in med.items()))
    return kernels, extra


def phase_a2a_times(torch, a2a, ring, moe, timing, info, lat, launches,
                    full_err, dev):
    """K10 and K11 at the shapes the mesh path gives them (64 MiB f32 a
    rank; the MoE dispatch at 4096 x 4096 of each routing, hot in the
    row), by CUDA events, beside their bound (each input read once, each
    output written once), their schedule bound (both one direct copy by
    tile table, which moves the bound), their plain versions and the
    library call (K10: the stacked transpose; K11: one index_select from
    the concatenated payloads by an int32 index built once, checked
    equal to K11's output first); both and their library calls also by
    card time (``_queued_ms``); and the mesh path's end-to-end alltoall
    latency."""
    bw = info.hbm_bw_gbps * 1e9
    gen = torch.Generator(device=dev).manual_seed(SEED + 700)
    c = N // R
    xs = [torch.randn(N, generator=gen, device=dev) for _ in range(R)]

    def transpose():
        return torch.stack(xs).view(R, R, c).transpose(0, 1).contiguous()

    k10 = {"name": "hbm_alltoall", "route": "cuda",
           "source": "mvapich2_tpu_torch/csrc/ring.cu",
           "replaces": "mvapich2_tpu/ops/pallas_alltoall.py:424",
           "launches": launches["hbm_alltoall"],
           "max_abs_err": full_err["K10"],
           "ms": timing.time_ms(lambda: a2a.hbm_alltoall(xs)),
           "plain_ms": timing.time_ms(lambda: a2a.hbm_alltoall_ref(xs),
                                      warmup=1, iters=5),
           "bound_ms": 2 * R * N * 4 / bw * 1e3, "bound_by": "bytes",
           "library_ms": timing.time_ms(transpose),
           "schedule_bound_ms": 2 * R * N * 4 / bw * 1e3,
           "schedule_bytes": "= bound: one direct copy by the uniform "
                             "tile table",
           "card_ms": _queued_ms(torch, lambda: a2a.hbm_alltoall(xs)),
           "library_card_ms": _queued_ms(torch, transpose)}
    del xs
    ring.check_errors()
    routings = {}
    for shape in ("hot", "skew", "uniform"):
        counts = _moe_counts(moe, shape)
        vs = [torch.randn(sum(counts[r]), generator=gen, device=dev)
              for r in range(R)]
        moved = 4 * sum(map(sum, counts))
        # the library form: one gather by index from the concatenated
        # payloads, rank j's receive run being every rank's block for j
        # in rank order (packed displacements); the index is built once
        flat = torch.cat(vs)
        starts = [0]
        for r in range(R):
            starts.append(starts[-1] + sum(counts[r]))
        idx = torch.cat([torch.arange(starts[r] + sum(counts[r][:j]),
                                      starts[r] + sum(counts[r][:j + 1]),
                                      dtype=torch.int32, device=dev)
                         for j in range(R) for r in range(R)])
        if not torch.equal(torch.cat(a2a.hbm_alltoallv(vs, counts)),
                           flat.index_select(0, idx)):
            raise AssertionError(f"K11 {shape} and its index_select "
                                 f"yardstick disagree")

        def kern():
            return a2a.hbm_alltoallv(vs, counts)

        def lib():
            return flat.index_select(0, idx)

        row = routings[shape] = {
            "moved_bytes": moved, "ms": timing.time_ms(kern),
            "card_ms": _queued_ms(torch, kern),
            "plain_ms": timing.time_ms(
                lambda: a2a.hbm_alltoallv_ref(vs, counts), warmup=1,
                iters=5),
            "bound_ms": 2 * moved / bw * 1e3,
            "library_ms": timing.time_ms(lib),
            "library_card_ms": _queued_ms(torch, lib)}
        row["card_share_of_bound"] = row["bound_ms"] / row["card_ms"]
        del vs, flat, idx
        ring.check_errors()
    hot = routings["hot"]
    k11 = {"name": "hbm_alltoallv", "route": "cuda",
           "source": "mvapich2_tpu_torch/csrc/ring.cu",
           "replaces": "mvapich2_tpu/ops/pallas_alltoall.py:488",
           "launches": launches["hbm_alltoallv"],
           "max_abs_err": full_err["K11"], "ms": hot["ms"],
           "plain_ms": hot["plain_ms"], "bound_ms": hot["bound_ms"],
           "bound_by": "bytes", "library_ms": hot["library_ms"],
           "schedule_bound_ms": hot["bound_ms"],
           "schedule_bytes": "2 a moved byte: one direct copy, the bound",
           "card_ms": hot["card_ms"],
           "library_card_ms": hot["library_card_ms"],
           "tile_bytes": a2a.TILE_BYTES, "routings": routings}
    rows = [k10, k11]
    extra = {"mesh_e2e_alltoall_ms": statistics.median(lat) * 1e3,
             "mesh_e2e_alltoall_ms_all": [t * 1e3 for t in lat],
             "mesh_e2e_alltoall_effbw_GBps":
                 (R - 1) / R * N * 4 / statistics.median(lat) / 1e9}
    log("[times] alltoall kernels " + "; ".join(
        f"{k['name']}: {k['ms']:.4f} ms, card {k['card_ms']:.4f} "
        f"({k['bound_ms'] / k['card_ms']:.1%} of the bound "
        f"{k['bound_ms']:.4f}), plain {k['plain_ms']:.4f}, "
        f"library {k['library_ms']:.4f}, card {k['library_card_ms']:.4f}, "
        f"launches {k['launches']}" for k in rows))
    log("[times] K11 by routing at 4096 x 4096 f32 (tiles of "
        f"{a2a.TILE_BYTES} bytes): " + "; ".join(
            f"{shape}: " + ", ".join(f"{k} {v:.4f}" for k, v in r.items()
                                     if k != "moved_bytes")
            for shape, r in routings.items()))
    log(f"[times] mesh e2e alltoall 64 MiB {extra['mesh_e2e_alltoall_ms']:.4f}"
        f" ms = {extra['mesh_e2e_alltoall_effbw_GBps']:.1f} GB/s effbw "
        f"((p-1)/p*m/t)")
    return rows, extra


def _queued_ms(torch, fn, iters=20, flush=None):
    """Device time in ms of one small ``fn()``, median of ``iters``
    after a warm-up: each call and its two CUDA events are queued behind
    a sleep kernel, so the events bracket the card's work and not the
    host's enqueue (which, at a few KiB, takes longer than the kernel).
    ``flush``, a tensor of at least 64 MiB, is zeroed after the sleep and
    before the first event, which evicts the 50 MB L2: the call then
    finds its inputs in device memory, as a first touch would."""
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def direct_ring_times(torch, np, ring, timing, bw, dev):
    """K6 and K7 at the mesh path's 8 x 64 KiB f32 and at their 4 MiB
    limit (K6: 8 x 4 MiB; K7: 8 x 512 KiB into 8 rows of 4 MiB), each
    beside its bound (each input read once, each output written once,
    over the memory rate) and the library form that writes every rank's
    copy (K6: stack, sum, expand; K7: cat, expand): host-inclusive CUDA
    events (``timing.time_ms``, each launch bracketed as the host
    enqueues it), card time (``_queued_ms``) and the host's time to
    enqueue one call (``host_ms``: perf_counter over 200 calls, no
    synchronize between them). At 4 MiB the card times are also taken
    with L2 evicted before each call, since the working set fits the
    50 MB L2. Then 200 K6 calls at 64 KiB under cProfile, the entries
    with the most own time. Returns {kernel: {size: numbers}}."""
    import cProfile
    import io
    import pstats

    def host_ms(fn, iters=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        dt = (time.perf_counter() - t0) / iters * 1e3
        torch.cuda.synchronize()
        return dt

    rng = np.random.default_rng(SEED + 310)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for name, fn, lib, shards in (
            ("ring_all_reduce", ring.ring_all_reduce,
             lambda xs: torch.stack(xs).sum(0),
             (("64KiB", SMALL_MESH, R * SMALL_MESH),
              ("4MiB", RESIDENT_FULL, R * RESIDENT_FULL))),
            ("ring_all_gather", ring.ring_all_gather, torch.cat,
             (("64KiB", SMALL_MESH, R * R * SMALL_MESH),
              ("4MiB", RESIDENT_FULL // R, R * RESIDENT_FULL)))):
        rows = out[name] = {}
        for tag, n, out_elems in shards:
            xs = [_data(torch, np, rng, (n,), "f32", dev) for _ in range(R)]

            def kern():
                return fn(xs)

            def every():
                return lib(xs).expand(R, -1).contiguous()

            row = rows[tag] = {
                "shard_bytes": n * 4,
                "bound_ms": (R * n + out_elems) * 4 / bw * 1e3,
                "ms": timing.time_ms(kern),
                "card_ms": _queued_ms(torch, kern),
                "library_ms": timing.time_ms(every),
                "library_card_ms": _queued_ms(torch, every),
                "host_ms": host_ms(kern),
                "library_host_ms": host_ms(every)}
            if tag == "4MiB":
                row["card_cold_ms"] = _queued_ms(torch, kern, flush=scratch)
                row["library_card_cold_ms"] = _queued_ms(torch, every,
                                                         flush=scratch)
    ring.check_errors()
    for name, rows in out.items():
        for tag, row in rows.items():
            log(f"[times] {name} {tag}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items() if k != "shard_bytes"))
    small = [_data(torch, np, rng, (SMALL_MESH,), "f32", dev)
             for _ in range(R)]
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(200):
        ring.ring_all_reduce(small)
    prof.disable()
    torch.cuda.synchronize()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(12)
    lines = [ln for ln in text.getvalue().splitlines() if ln.strip()]
    log("[times] cProfile of 200 K6 calls at 8 x 64 KiB, top 12 by own "
        "time:")
    for ln in lines:
        log(f"[times]   {ln}")
    out["k6_host_profile"] = lines
    return out


def phase_rma_times(torch, rma, ring, timing, info, launches, full_err,
                    art, dev):
    """K12, K13, K14 and K17 at the path's whole-window shape (N f32
    elements, origin 0, target 7, disp 0), by CUDA events, beside their
    bound (2 bytes a payload byte, 3 for the accumulate), their schedule
    bound (the bound: one direct pass each), their plain versions and
    the library call; K12, K13 and K14 also at N - 7 elements at disp 5
    (misaligned by 4 bytes against the source), K12 and K13 at one op of
    1 KiB and 64 KiB (those two queued behind a sleep kernel,
    ``_queued_ms``), each beside copy_ or add_ on the same tensors; and
    the OSU band of the path."""
    bw = info.hbm_bw_gbps * 1e9
    gen = torch.Generator(device=dev).manual_seed(SEED + 1100)
    win = torch.randn(R, N, generator=gen, device=dev)
    src = torch.randn(N, generator=gen, device=dev)
    out = torch.empty(N, device=dev)
    t, nb = R - 1, N * 4
    rows = []
    for name, kern, src_line, fn, plain, lib, nbytes, sched, formula in (
            ("rma_put", "K12", "mvapich2_tpu/ops/pallas_rma.py:398",
             lambda: rma.rma_put(src, win, 0, t),
             lambda: rma.rma_put_ref(src, win, 0, t),
             lambda: win[t].copy_(src), 2 * nb, 2 * nb,
             "2n: read src, write window"),
            ("rma_get", "K13", "mvapich2_tpu/ops/pallas_rma.py:429",
             lambda: rma.rma_get(win, N, 0, t),
             lambda: rma.rma_get_ref(win, N, 0, t),
             lambda: out.copy_(win[t]), 2 * nb, 2 * nb,
             "2n: read window, write result"),
            ("rma_accumulate", "K14", "mvapich2_tpu/ops/pallas_rma.py:458",
             lambda: rma.rma_accumulate(src, win, 0, t),
             lambda: rma.rma_accumulate_ref(src, win, 0, t),
             lambda: win[t].add_(src), 3 * nb, 3 * nb,
             "3n: read src and window, write window"),
            ("direct_put", "K17", "mvapich2_tpu/rma/device.py:469",
             lambda: rma.direct_put(src, win, 0, t),
             lambda: rma.rma_put_ref(src, win, 0, t),
             lambda: win[t].copy_(src), 2 * nb, 2 * nb,
             "2n: K12's direct copy, read src, write window")):
        ms = timing.time_ms(fn)
        plain_ms = timing.time_ms(plain, warmup=1, iters=5)
        lib_ms = timing.time_ms(lib)
        ring.check_errors()
        rows.append({"name": name, "route": "cuda",
                     "source": "mvapich2_tpu_torch/csrc/ring.cu",
                     "replaces": src_line, "launches": launches[name],
                     "max_abs_err": full_err[kern], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": nbytes / bw * 1e3,
                     "bound_by": "bytes", "library_ms": lib_ms,
                     "schedule_bound_ms": sched / bw * 1e3,
                     "schedule_bytes": formula})
    # K12/K13 off the aligned shape: N - 7 at disp 5, and one small op
    m = N - 7
    shapes = {"misaligned": (
        lambda: rma.rma_put(src[:m], win, 0, t, 5),
        lambda: win[t, 5:5 + m].copy_(src[:m]),
        lambda: rma.rma_get(win, m, 0, t, 5),
        lambda: out[:m].copy_(win[t, 5:5 + m]))}
    for size in (1 << 10, 64 << 10):
        k = size // 4
        shapes[str(size)] = (
            lambda k=k: rma.rma_put(src[:k], win, 0, t),
            lambda k=k: win[t, :k].copy_(src[:k]),
            lambda k=k: rma.rma_get(win, k, 0, t),
            lambda k=k: out[:k].copy_(win[t, :k]))
    for shape, (put, put_lib, get, get_lib) in shapes.items():
        clock = timing.time_ms if shape == "misaligned" else \
            (lambda f: _queued_ms(torch, f))
        for row, fn, lib in ((rows[0], put, put_lib),
                             (rows[1], get, get_lib)):
            row.setdefault("shapes", {})[shape] = {
                "ms": clock(fn), "library_ms": clock(lib)}
    rows[2]["shapes"] = {"misaligned": {
        "ms": timing.time_ms(lambda: rma.rma_accumulate(src[:m], win, 0, t,
                                                        5)),
        "library_ms": timing.time_ms(
            lambda: win[t, 5:5 + m].add_(src[:m]))}}
    ring.check_errors()
    extra = {"osu_rma": art}
    log("[times] RMA kernels at 64 MiB " + "; ".join(
        f"{k['name']}: {k['ms']:.4f} ms (bound {k['bound_ms']:.4f}, schedule "
        f"bound {k['schedule_bound_ms']:.4f}, plain {k['plain_ms']:.4f}, "
        f"library {k['library_ms']:.4f}), launches {k['launches']}"
        for k in rows))
    log("[times] K12/K13/K14 off the aligned shape, ms (copy_ or add_ "
        "beside): "
        + "; ".join(f"{k['name']} {shape} {v['ms']:.4f} "
                    f"({v['library_ms']:.4f})"
                    for k in rows[:3] for shape, v in k["shapes"].items()))
    res, lat = art["results"], art["latency_us"]
    for kind, band in (("put", "dev_put_bw"), ("get", "dev_get_bw"),
                       ("acc", "dev_acc_bw")):
        log(f"[times] OSU {band} MB/s (per-op us): " + ", ".join(
            f"{size} B {res[band][size]:.1f} ({lat[kind][size]:.2f})"
            for size in res[band]))
    log("[times] OSU whole-window ops, host ms: " + ", ".join(
        f"{k} {v['ms']:.4f}" for k, v in art["whole"].items()))
    return rows, extra

def phase_quant_kernels(torch, np, quant, ici, rma, ring, cfg, dev):
    """K9 and K14's quantized wire (K14q) against their plain versions,
    bitwise. K9 through the whole quant_ring_all_reduce (one launch: the
    ring's codec chain, the owner's encode, the decode into every rank's
    row): p = 2, 4 and 8, both wires, f32 and f16 (cast; bf16 must take
    the exact K3 ring, as in the JAX package), padded tails, odd n (rows
    off their 16-byte boundary), blocks of 8, 12, 32, 128 (the default),
    512, 1024 and 2048 f32 values (past 128 the scratch row), shards at
    element offset 1 (the element loads), the chunk and depth arguments
    (which shape nothing), one and two ring directions, and 8 ranks of
    64 MiB; then K9's own wire words against encode_f32_ref of the plain
    reduced block. K14q: both wires, blocks of 8 to 256 f32, misaligned
    disp, a misaligned source, a zero block, the exact alias, the chunk
    and depth arguments, origin == target, and N - 128 elements of a 64
    MiB-a-rank window at disp 5, every window row compared. Returns the
    max abs error of the full-size checks."""
    rng = np.random.default_rng(SEED + 1400)
    n_checks = 0
    full_err = {}

    def check(what, got, want, key=None):
        nonlocal n_checks
        torch.cuda.synchronize()
        ring.check_errors()
        err = _compare(torch, what, got, want, "i32")      # bitwise
        n_checks += 1
        if key:
            full_err[key] = err

    # (n, block bytes, chunk bytes, depth, bidirectional, shard offset)
    shapes = ((37, 32, 128, 2, True, 0),       # padded tail, odd n
              (300, 64, 256, 3, False, 0),
              (1000, None, None, 2, True, 0),  # the default block
              (100003, None, 4096, 3, True, 0),
              (4096, 32, 1 << 20, 2, False, 0),
              (1001, 48, None, 2, True, 0),    # 12-value blocks, 3 words
              (5003, 2048, None, 2, True, 0),  # 512 values: the scratch row
              (9999, 4096, None, 3, True, 0),  # 1024
              (20001, 8192, None, 2, False, 0),   # 2048
              (4099, None, None, 2, True, 1))  # shards at element offset 1
    for p in (2, 4, 8):
        for wire in ("q8", "fp8"):
            for kind in ("f32", "f16", "bf16"):
                for n, bb, cb, depth, bidir, off in shapes:
                    if off:
                        x = _data(torch, np, rng, (p, n + off), kind, dev)
                        xs = [x[r, off:] for r in range(p)]
                    else:
                        xs = _shards(torch, np, rng, p, n, kind, dev)
                    ici.reset_counts()
                    got = quant.quant_ring_all_reduce(
                        xs, wire=wire, block_bytes=bb, chunk_bytes=cb,
                        depth=depth, bidirectional=bidir)
                    want_l = {k: 0 for k in ici.LAUNCHES}
                    want_l["hbm_ring_all_reduce" if kind == "bf16"
                           else "quant_ring_all_reduce"] = 1
                    if ici.LAUNCHES != want_l:
                        raise AssertionError(f"K9 {kind}: launches "
                                             f"{dict(ici.LAUNCHES)}")
                    check(f"K9 p={p} n={n} {wire} {kind} block={bb} "
                          f"chunk={cb} depth={depth} bidir={bidir} "
                          f"offset={off}", got,
                          quant.quant_ring_all_reduce_ref(
                              xs, wire=wire, block_bytes=bb,
                              bidirectional=bidir))
    for p, wire, n, bb in ((2, "q8", 1000, 32), (8, "fp8", 100003, None),
                           (8, "q8", 300, 64), (4, "fp8", 1001, 48),
                           (4, "q8", 20001, 8192)):
        xs = _shards(torch, np, rng, p, n, "f32", dev)
        blk, nblk = quant._geometry(p, n, bb)
        ndir = 2 if p > 2 else 1
        wires = quant.quant_reduce_scatter(xs, nblk, blk, wire, ndir)
        _, own = quant.quant_reduce_scatter_ref(xs, nblk, blk, wire, ndir)
        check(f"K9 own wire p={p} n={n} {wire} block={blk}", wires,
              quant.encode_f32_ref(own, blk, wire).reshape(p, -1))
    gen = torch.Generator(device=dev).manual_seed(SEED + 1450)
    xs = [torch.randn(N, generator=gen, device=dev) for _ in range(R)]
    for wire in ("q8", "fp8"):
        check(f"K9 8 x 64 MiB f32 {wire}",
              quant.quant_ring_all_reduce(xs, wire=wire),
              quant.quant_ring_all_reduce_ref(xs, wire=wire),
              "K9" if wire == "q8" else None)
    del xs
    # K14q: (p, length, n, disp, origin, target, chunk bytes, depth,
    # QUANT_BLOCK bytes); the wire is MV2T_QUANT_COLL's
    for wire in ("q8", "fp8"):
        cfg.set("QUANT_COLL", f"{wire}:1e-1")
        for p, length, n, disp, o, t, cb, depth, qb in (
                (8, 1024, 512, 5, 0, 7, 16, 2, 512),
                (8, 1000, 384, 7, 2, 5, None, 3, 128),
                (4, 4096, 4000, 96, 3, 0, 256, 4, 64),
                (2, 300, 256, 1, 1, 1, 64, 2, 512),     # origin == target
                (8, 100, 40, 3, 6, 6, 32, 2, 32)):      # 8-f32 blocks
            cfg.set("QUANT_BLOCK", qb)
            win = _data(torch, np, rng, (p, length), "f32", dev)
            src = _data(torch, np, rng, (n,), "f32", dev)
            got, want = win.clone(), win.clone()
            rma.rma_accumulate(src, got, o, t, disp, quantized=True,
                               chunk_bytes=cb, depth=depth)
            rma.rma_accumulate_ref(src, want, o, t, disp, quantized=True)
            check(f"K14q p={p} N={length} n={n} disp={disp} {o}->{t} "
                  f"{wire} chunk={cb} depth={depth} block={qb}", got, want)
    # the direct form's own cases: blocks of 64, 128 and 256 values (16,
    # 32 and 64 four-value words: half the warp's lanes idle, one word a
    # lane, two words a lane), window
    # rows at disp 0 and 5 (off their 16-byte boundary), a source at
    # offset 1 of a larger tensor, one block of zeros (scale 0), and the
    # exact alias (the target range itself)
    for wire in ("q8", "fp8"):
        cfg.set("QUANT_COLL", f"{wire}:1e-1")
        for qb in (256, 512, 1024):
            cfg.set("QUANT_BLOCK", qb)
            blk = qb // 4
            n = 7 * blk
            for disp in (0, 5):
                win = _data(torch, np, rng, (4, n + 19), "f32", dev)
                src = _data(torch, np, rng, (n + 1,), "f32", dev)[1:]
                src[2 * blk:3 * blk] = 0.0
                got, want = win.clone(), win.clone()
                rma.rma_accumulate(src, got, 0, 2, disp, quantized=True)
                rma.rma_accumulate_ref(src, want, 0, 2, disp, quantized=True)
                check(f"K14q {wire} block={blk} disp={disp}", got, want)
                got, want = win.clone(), win.clone()
                rma.rma_accumulate(got[2, disp:disp + n], got, 0, 2, disp,
                                   quantized=True)
                rma.rma_accumulate_ref(want[2, disp:disp + n].clone(), want,
                                       0, 2, disp, quantized=True)
                check(f"K14q {wire} block={blk} disp={disp} alias", got,
                      want)
    cfg.set("QUANT_BLOCK", 512)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1460)
    win = torch.randn(R, N, generator=gen, device=dev)
    src = torch.randn(N - 128, generator=gen, device=dev)
    for wire in ("q8", "fp8"):
        cfg.set("QUANT_COLL", f"{wire}:1e-1")
        got, want = win.clone(), win.clone()
        rma.rma_accumulate(src, got, 0, R - 1, 5, quantized=True)
        rma.rma_accumulate_ref(src, want, 0, R - 1, 5, quantized=True)
        check(f"K14q 64 MiB-a-rank window {wire}", got, want,
              "K14q" if wire == "q8" else None)
    cfg.set("QUANT_COLL", "")
    del win, src, got, want
    log(f"[kernels] {n_checks} quant kernel-vs-plain checks passed, "
        f"bitwise (full-size max abs err: "
        + ", ".join(f"{k} {v:.3g}" for k, v in full_err.items()) + ")")
    return full_err


def phase_quant(torch, np, mvt, quant, ici, ring, mpit, opmod, cfg, dev,
                inputs):
    """The quant tier's main path: run_ranks(8) bound one to one to a
    mesh of 8 virtual ranks on cuda:0, comm.allreduce of the 64 MiB f32
    inputs under each of QUANT_SPECS (2 checked calls, 2 warm-ups, 10
    timed), then, under the same budget, an int32 sum and an f32 max of
    64 MiB and an allgather of 8 MiB a rank (64 MiB gathered), which the
    quant bin must send to the exact K3/K5. A quantized call is one K9
    launch (no K5 over the wire, no stock decode). Every quantized result is
    bitwise the plain version on the card on every rank, and within
    declared_bound of an f64 sum; the exact ones bitwise the plain
    reductions. Counts zeroed before each run and read after it; the
    tier pvars checked. Returns (K9 launches, e2e latencies in s by
    wire)."""
    mesh = mvt.make_mesh((R,), ("x",), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1200)
    ints = [torch.randint(-2**31, 2**31 - 1, (N,), generator=gen,
                          device=dev, dtype=torch.int32) for _ in range(R)]
    ag = [torch.randn(N // R, generator=gen, device=dev) for _ in range(R)]
    exact_b, wire_b = quant.wire_stats(N, torch.float32, R)
    if exact_b - wire_b != QUANT_SAVED:
        raise AssertionError(f"wire_stats at 64 MiB: {exact_b} - {wire_b}")
    n_check, n_warm, n_timed = 2, 2, 10
    n_q = n_check + n_warm + n_timed
    pvs = ("dev_coll_tier_quant", "dev_coll_quant_bytes_saved",
           "dev_coll_tier_hbm", "dev_coll_tier_vmem")
    exact64 = torch.stack(inputs).double().sum(0)
    want_int = ici.hbm_ring_all_reduce_ref(ints)[0]
    want_max = torch.stack(inputs).amax(0)
    want_ag = torch.cat(ag)
    k9_launches, lats = 0, {}
    for spec, wire in QUANT_SPECS:
        cfg.set("QUANT_COLL", spec)

        def app(comm):
            r = comm.rank
            stream = torch.cuda.current_stream()
            outs = [comm.allreduce(inputs[r]) for _ in range(n_check)]
            for _ in range(n_warm):
                comm.allreduce(inputs[r])
            lat = []
            for _ in range(n_timed):
                t0 = time.perf_counter()
                comm.allreduce(inputs[r])
                stream.synchronize()
                lat.append(time.perf_counter() - t0)
            exact = (comm.allreduce(ints[r]),
                     comm.allreduce(inputs[r], op=opmod.MAX),
                     comm.allgather(ag[r]))
            stream.synchronize()
            return outs, lat, exact

        before = {k: mpit.pvar(k).read() for k in pvs}
        ici.reset_counts()
        ring.reset_counts()
        t0 = time.perf_counter()
        res = mvt.run_ranks(R, app, device_mesh=mesh)
        torch.cuda.synchronize()
        ring.check_errors()
        wall = time.perf_counter() - t0
        launches = dict(ici.LAUNCHES)
        want_l = {"hbm_ring_all_reduce": 2, "hbm_ring_all_gather": 1,
                  "quant_ring_all_reduce": n_q,
                  "hbm_ring_reduce_scatter": 0, "remote_sendrecv": 0}
        if launches != want_l or any(ring.LAUNCHES.values()) or \
                any(ici.PLAIN_CALLS.values()):
            raise AssertionError(f"[quant] {spec}: launches {launches} "
                                 f"(expected {want_l}), resident "
                                 f"{ring.LAUNCHES}, plain {ici.PLAIN_CALLS}")
        k9_launches += launches["quant_ring_all_reduce"]
        delta = {k: mpit.pvar(k).read() - before[k] for k in pvs}
        want_d = {"dev_coll_tier_quant": R * n_q,
                  "dev_coll_quant_bytes_saved": R * n_q * QUANT_SAVED,
                  "dev_coll_tier_hbm": R * 3, "dev_coll_tier_vmem": 0}
        if delta != want_d:
            raise AssertionError(f"[quant] {spec}: pvars moved by {delta}, "
                                 f"expected {want_d}")
        want = quant.quant_ring_all_reduce_ref(inputs, wire=wire)[0]
        rel = 0.0
        for r in range(R):
            for g in res[r][0]:
                if g.shape != (N,) or not torch.isfinite(g).all():
                    raise AssertionError("[quant] result has the wrong "
                                         "shape or non-finite values")
                _compare(torch, f"[quant] {spec} rank {r}", g, want, "i32")
            rel = max(rel, ((res[r][0][0].double() - exact64).abs().max()
                            / exact64.abs().max()).item())
            i_sum, f_max, gath = res[r][2]
            _compare(torch, "[quant] int32 sum", i_sum, want_int, "i32")
            _compare(torch, "[quant] f32 max", f_max, want_max, "i32")
            _compare(torch, "[quant] allgather", gath, want_ag, "i32")
        bound = quant.declared_bound(R, wire)
        if rel > bound:
            raise AssertionError(f"[quant] {spec}: relative error {rel} "
                                 f"past declared_bound {bound}")
        lats[wire] = res[0][1]
        log(f"[quant] run_ranks({R}, device_mesh={mesh}), MV2T_QUANT_COLL="
            f"{spec}: {n_q} allreduces of 64 MiB f32 a rank, + an int32 "
            f"sum, an f32 max and a 64 MiB allgather in {wall:.2f} s; every "
            f"rank bitwise the plain version, relative error {rel:.4g} "
            f"(declared bound {bound:.4g}); exact calls bitwise; launches "
            f"{launches}; pvars {delta}")
        del res
    cfg.set("QUANT_COLL", "")
    return k9_launches, lats


def phase_rma_quant(torch, rma, ring, mpit, cfg, dev):
    """K14's quantized wire on the one-sided path: a DeviceWin of 64 MiB
    f32 a rank over 8 virtual ranks; under MV2T_QUANT_COLL=q8:1e-1 a
    4 MiB accumulate from rank 0 into rank 7 at disp 4096, closed by a
    fence, must take the quant tier (one K14q launch, counts zeroed
    just before), count its wire words in dev_rma_wire_bytes, and leave
    the window bitwise the plain quantized accumulate. Returns the
    launch count."""
    from mvapich2_tpu_torch.parallel import MeshComm, make_mesh
    from mvapich2_tpu_torch.rma import DeviceWin
    cfg.set("QUANT_COLL", "q8:1e-1")
    win = DeviceWin(MeshComm(make_mesh((R,), ("x",), dev)), N)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1300)
    win.win.copy_(torch.randn(R, N, generator=gen, device=dev))
    m = min(1 << 20, N // 4)                   # 4 MiB at the full size
    src = torch.randn(m, generator=gen, device=dev)
    want = win.win.clone()
    pvs = ("dev_rma_tier_quant", "dev_rma_tier_rdma", "dev_rma_wire_bytes")
    before = {k: mpit.pvar(k).read() for k in pvs}
    rma.reset_counts()
    win.accumulate(src, 0, R - 1, disp=4096)
    win.fence()
    torch.cuda.synchronize()
    ring.check_errors()
    launches = dict(rma.LAUNCHES)
    delta = {k: mpit.pvar(k).read() - before[k] for k in pvs}
    wire = rma.wire_words(m, rma.quant_block_elems()) * 4
    want_d = {"dev_rma_tier_quant": 1, "dev_rma_tier_rdma": 0,
              "dev_rma_wire_bytes": wire}
    if launches["rma_accumulate_quant"] != 1 or \
            sum(launches.values()) != 1 or delta != want_d:
        raise AssertionError(f"[rma] quant: launches {launches}, pvars "
                             f"{delta} (expected {want_d})")
    rma.rma_accumulate_ref(src, want, 0, R - 1, 4096, quantized=True)
    _compare(torch, "[rma] quant window", win.win, want, "i32")
    cfg.set("QUANT_COLL", "")
    log(f"[rma] quant: DeviceWin {R} x {N} f32, a 4 MiB accumulate under "
        f"q8:1e-1 took K14's quantized wire ({wire} wire bytes for "
        f"{m * 4}); window bitwise the plain version; launches {launches}; "
        f"pvars {delta}")
    return launches["rma_accumulate_quant"]


def phase_quant_times(torch, quant, ici, rma, ring, timing, info, smi,
                      cfg, k9_launches, k14q_launches, full_err, q_lats,
                      mesh_lat, dev):
    """K9 and K14q at the main paths' shapes, by CUDA events (median of
    20 after 3 warm-ups; plain versions 5 after 1) and by card time
    (``_queued_ms``): the whole quant_ring_all_reduce at 8 x 64 MiB f32
    (one K9 launch) on the q8 and fp8 wires, K9's wire-only form
    (quant_reduce_scatter), and beside them the parent form's tail (K5
    gathering the wire words, then the stock decode), K3 and
    torch.stack(x).sum(0) on the same input; the device memory a call
    allocates, and what the parent form's tail (K5 and the decode)
    allocates on top of the wire outputs; K14q at N = 16 Mi f32 elements
    from rank 0 into rank 7 beside K14 and win[7].add_(src); and the e2e
    quant mesh allreduce beside the exact one. Bounds: each input read
    once, each output written once (K9: the inputs and every rank's
    result row; K14q: src, the window row and the row written back),
    over the memory rate."""
    bw = info.hbm_bw_gbps * 1e9
    gen = torch.Generator(device=dev).manual_seed(SEED + 1500)
    xs = [torch.randn(N, generator=gen, device=dev) for _ in range(R)]
    blk, nblk = quant._geometry(R, N, None)
    ndir = ici._resolve_ndir(R, None)
    wblk = quant.wire_words(nblk, blk)
    k9, k9_card = {}, {}
    for wire in ("q8", "fp8"):
        k9[wire] = timing.time_ms(lambda: quant.quant_ring_all_reduce(
            xs, wire=wire))
        k9_card[wire] = _queued_ms(torch, lambda: quant.quant_ring_all_reduce(
            xs, wire=wire))
    wires_only = timing.time_ms(lambda: quant.quant_reduce_scatter(
        xs, nblk, blk, "q8", ndir))
    own = quant.quant_reduce_scatter(xs, nblk, blk, "q8", ndir)
    own_rows = list(own.unbind(0))
    k5 = timing.time_ms(lambda: ici.hbm_ring_all_gather(own_rows))
    wall = ici.hbm_ring_all_gather(own_rows)
    dec = timing.time_ms(lambda: quant.decode_f32_ref(wall, blk, "q8")
                         [:, :N].to(torch.float32))
    k3 = timing.time_ms(lambda: ici.hbm_ring_all_reduce(xs))
    k3_card = _queued_ms(torch, lambda: ici.hbm_ring_all_reduce(xs))
    plain = timing.time_ms(lambda: quant.quant_ring_all_reduce_ref(
        xs, wire="q8"), warmup=1, iters=5)
    exact_sum = timing.time_ms(lambda: torch.stack(xs).sum(0))
    ring.check_errors()
    # the device memory of one call, and of the parent form's tail
    del wall
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = quant.quant_ring_all_reduce(xs, wire="q8")
    torch.cuda.synchronize()
    alloc = torch.cuda.max_memory_allocated() - base
    del out
    torch.cuda.reset_peak_memory_stats()
    tail = quant.decode_f32_ref(ici.hbm_ring_all_gather(own_rows), blk,
                                "q8")[:, :N].to(torch.float32)
    torch.cuda.synchronize()
    tail_alloc = torch.cuda.max_memory_allocated() - base
    del tail
    m, wr = N * 4, wblk / nblk                   # wire bytes a f32 byte
    ops9 = R * nblk * R * 6          # abs, max, div, round, fma a hop, p hops
    tb = 2 * R * m / bw
    to = ops9 / (F32_PEAK_TFLOPS * 1e12)
    b9, by9 = (tb, "bytes") if tb >= to else (to, "operations")
    parent_sched = R * (2 * m + (R - 1) * (m / R) * (3 + 2 * wr)
                        + (m / R) * (1 + wr))
    del xs, own, own_rows
    win = torch.randn(R, N, generator=gen, device=dev)
    src = torch.randn(N, generator=gen, device=dev)
    t = R - 1
    cfg.set("QUANT_COLL", "q8:1e-1")
    k14q = timing.time_ms(lambda: rma.rma_accumulate(
        src, win, 0, t, quantized=True))
    k14 = timing.time_ms(lambda: rma.rma_accumulate(src, win, 0, t))
    plain14 = timing.time_ms(lambda: rma.rma_accumulate_ref(
        src, win, 0, t, quantized=True), warmup=1, iters=5)
    cfg.set("QUANT_COLL", "")
    add = timing.time_ms(lambda: win[t].add_(src))
    ring.check_errors()
    wq = quant.wire_words(N, quant.quant_block_elems()) * 4
    rows = [
        {"name": "quant_ring_all_reduce", "route": "cuda",
         "source": "mvapich2_tpu_torch/csrc/ring.cu",
         "replaces": "mvapich2_tpu/ops/pallas_quant.py:377",
         "launches": k9_launches, "max_abs_err": full_err["K9"],
         "ms": k9["q8"], "plain_ms": plain, "bound_ms": b9 * 1e3,
         "bound_by": by9, "library_ms": None,
         "schedule_bound_ms": b9 * 1e3,
         "schedule_bytes": "p*m_in + p*m_out (one pass)",
         "card_ms": k9_card["q8"], "fp8_ms": k9["fp8"],
         "fp8_card_ms": k9_card["fp8"], "wires_only_ms": wires_only,
         "parent_schedule_bound_ms": parent_sched / bw * 1e3,
         "k5_wire_gather_ms": k5, "decode_ms": dec, "k3_ms": k3,
         "k3_card_ms": k3_card, "exact_sum_ms": exact_sum,
         "alloc_bytes": alloc, "parent_tail_alloc_bytes": tail_alloc},
        {"name": "rma_accumulate_quant", "route": "cuda",
         "source": "mvapich2_tpu_torch/csrc/ring.cu",
         "replaces": "mvapich2_tpu/ops/pallas_rma.py:458",
         "launches": k14q_launches, "max_abs_err": full_err["K14q"],
         "ms": k14q, "plain_ms": plain14, "bound_ms": 3 * m / bw * 1e3,
         "bound_by": "bytes", "library_ms": None,
         "schedule_bound_ms": 3 * m / bw * 1e3,
         "schedule_bytes": "3n: read src and window, write window (the "
                           "wire stays in registers)", "wire_bytes": wq,
         "exact_add_ms": add, "k14_ms": k14}]
    e2e = {w: statistics.median(v) * 1e3 for w, v in q_lats.items()}
    extra = {"quant_e2e_allreduce_ms": e2e,
             "quant_e2e_allreduce_ms_all": {w: [x * 1e3 for x in v]
                                            for w, v in q_lats.items()},
             "exact_e2e_allreduce_ms": statistics.median(mesh_lat[0]) * 1e3}
    log(f"[times] quant ({smi}): quant_ring_all_reduce (one K9) q8 "
        f"{k9['q8']:.4f} ms, card {k9_card['q8']:.4f}; fp8 {k9['fp8']:.4f}, "
        f"card {k9_card['fp8']:.4f} (bound {b9 * 1e3:.4f}, plain "
        f"{plain:.4f}); wires only {wires_only:.4f}; the parent form's K5 "
        f"over the wire {k5:.4f}, decode {dec:.4f}; K3 {k3:.4f}, card "
        f"{k3_card:.4f}; stack+sum {exact_sum:.4f}; device memory a call "
        f"{alloc} bytes (the parent form's K5 and decode {tail_alloc}); "
        f"K14q "
        f"{k14q:.4f} ms (bound {3 * m / bw * 1e3:.4f}, plain {plain14:.4f}), "
        f"K14 {k14:.4f}, add_ {add:.4f}; e2e mesh allreduce 64 MiB: quant "
        + ", ".join(f"{w} {v:.4f}" for w, v in e2e.items())
        + f" ms, exact {extra['exact_e2e_allreduce_ms']:.4f} ms")
    return rows, extra


# ---------------------------------------------------------------------------
# sequence-parallel attention: K15, K16 and the ring / Ulysses paths
# ---------------------------------------------------------------------------

def _set_f32_matmul(torch, tf32):
    """Full f32 products for the plain versions (TF32 only to show that
    the tolerance tells them apart)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def _ulp_close(torch, got, want):
    """16-bit outputs: the two f32 results may differ within ATTN_TOL
    before they are rounded, and each rounding moves a value by at most
    half an ulp, so |got - want| <= one ulp of the output's dtype (at
    the larger of the two) + atol + rtol * |want|. An output near 0 that
    sums terms far larger than itself needs the f32 part; one of
    magnitude 1 the ulp."""
    g, w = got.float(), want.float()
    mant = {torch.bfloat16: 7, torch.float16: 10}[want.dtype]
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -14)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - mant)
    lim = ulp + ATTN_TOL["atol"] + ATTN_TOL["rtol"] * w.abs()
    return bool(((g - w).abs() <= lim).all())


def _attn_check(torch, what, got, want):
    """K15's output or one f32 part against the plain version: ATTN_TOL
    in f32, and one ulp more in a 16-bit dtype (``_ulp_close``). Returns
    the max abs error."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{what}: non-finite output")
    err = (got.double() - want.double()).abs().max().item()
    ok = (torch.allclose(got, want, **ATTN_TOL)
          if got.dtype == torch.float32 else _ulp_close(torch, got, want))
    if not ok:
        raise AssertionError(f"{what}: kernel and plain version disagree "
                             f"(max abs err {err})")
    return err


def _parts_check(torch, what, got, want):
    """K16's (m, num, den): m and den within ATTN_TOL; num is den times a
    value of the output's scale (out = num / den), so it is held to the
    output's tolerance carried through the normalisation, |d num| <=
    atol * den + rtol * |num|."""
    err = max(_attn_check(torch, what + " m", got[0], want[0]),
              _attn_check(torch, what + " den", got[2], want[2]))
    num, ref, den = got[1], want[1], want[2]
    if num.shape != ref.shape or not bool(torch.isfinite(num).all()):
        raise AssertionError(f"{what} num: shape or non-finite")
    d = (num - ref).abs()
    lim = ATTN_TOL["atol"] * den.transpose(-1, -2)[..., None] + \
        ATTN_TOL["rtol"] * ref.abs()
    if not bool((d <= lim).all()):
        raise AssertionError(f"{what} num: kernel and plain version "
                             f"disagree (max abs err {d.max().item()})")
    return max(err, d.max().item())


# K15: (batch or None, T, Tk, H, D, causal, q0, k0, block_q, block_k); the
# CPU tests' cases, a batch of ranks, the widths the kernel is built for
K15_CASES = ((None, 256, 256, 4, 64, True, 0, 0, 64, 64),
             (None, 256, 256, 4, 64, False, 0, 0, 64, 64),
             (None, 128, 128, 2, 32, True, 0, 128, 64, 64),   # wholly future
             (None, 128, 128, 2, 32, True, 128, 0, 64, 64),   # wholly past
             (None, 128, 128, 2, 32, True, 0, 64, 64, 64),    # floor walk
             (None, 96, 96, 2, 32, True, 0, 0, 64, 64),       # gcd blocks
             (None, 96, 160, 2, 128, True, 40, 7, 64, 48),    # ragged
             (None, 64, 128, 2, 16, True, 0, 1, 64, 64),      # a keyless row
             (3, 100, 37, 3, 16, True, 50, 20, 128, 128),
             (2, 200, 200, 2, 256, True, 0, 0, 128, 128),
             (8, 512, 512, 2, 128, True, 0, 0, 128, 128))
# K16: (batch or None, T, Tk, H, D, causal, block_q, block_k)
K16_CASES = ((None, 128, 128, 2, 32, True, 64, 64),
             (None, 128, 128, 2, 32, False, 64, 64),
             (None, 96, 96, 2, 32, True, 64, 64),
             (None, 64, 96, 2, 32, True, 16, 32),
             (7, 300, 300, 4, 128, False, 128, 128),
             (2, 200, 200, 2, 256, True, 128, 128))
# K15 and K16 with q and k scaled by ATTN_SHARP: (batch, T, H, D, causal)
SHARP_CASES = ((2, 512, 2, 128, True), (2, 512, 4, 128, False))


def phase_flash_kernels(torch, flash, dev):
    """K15 and K16 against their plain versions on the card, with full
    f32 products: the CPU tests' cases (causal and full, the q0/k0
    offsets with wholly-future and wholly-past blocks, a query tile that
    ends one key before the block, gcd-shrunk blocks, a row with no
    key) in f32, bf16 and f16, batches of ranks, head widths 16 to 256,
    then q and k scaled by ATTN_SHARP (sharp logits, where the split
    TF32 products' small terms matter), then the main paths' shapes: K15
    over Ulysses' 8 x 2 head rows of 32,768 tokens, K16 over the ring's
    diagonal step and its first past step, each also against f64
    attention on the last ATTN_SAMPLE rows of every head row
    (``_f64_check``). Then the plain version with TF32 on, which must
    fall outside the tolerance. Returns the max abs errors of the
    full-size checks."""
    _set_f32_matmul(torch, False)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1600)

    def rnd(shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def shapes(b, t, h, d):
        return (t, h, d) if b is None else (b, t, h, d)

    n = 0
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for b, T, Tk, H, D, causal, q0, k0, bq, bk in K15_CASES:
            q = rnd(shapes(b, T, H, D), dt)
            k, v = rnd(shapes(b, Tk, H, D), dt), rnd(shapes(b, Tk, H, D), dt)
            got = flash.flash_attention(q, k, v, causal, q0, k0, bq, bk)
            want = flash.flash_attention_ref(q, k, v, causal, q0, k0, bq, bk)
            torch.cuda.synchronize()
            what = f"K15 {dt} {(b, T, Tk, H, D, causal, q0, k0, bq, bk)}"
            _attn_check(torch, what, got, want)
            if q0 + T <= k0 and got.any():
                raise AssertionError(f"{what}: a wholly-future block must "
                                     f"give 0")
            n += 1
        for b, T, Tk, H, D, causal, bq, bk in K16_CASES:
            q = rnd(shapes(b, T, H, D), dt)
            k, v = rnd(shapes(b, Tk, H, D), dt), rnd(shapes(b, Tk, H, D), dt)
            got = flash.flash_attention_parts(q, k, v, causal, bq, bk)
            want = flash.flash_attention_parts_ref(q, k, v, causal, bq, bk)
            torch.cuda.synchronize()
            _parts_check(torch, f"K16 {dt} {(b, T, Tk, H, D, causal)}", got,
                         want)
            n += 1
    # sharp logits: q and k scaled up, so the split's small terms matter.
    # Held against f64 attention on every row: the plain f32 version
    # errs there by about ATTN_TOL's atol itself
    f64 = {}
    for b, T, H, D, causal in SHARP_CASES:
        q, k = (rnd((b, T, H, D)) * ATTN_SHARP for _ in range(2))
        v = rnd((b, T, H, D))
        what = f"sharp x{ATTN_SHARP:g} {(b, T, H, D, causal)}"
        f64["K15 " + what] = _f64_check(
            torch, flash, "K15 " + what, flash.flash_attention(q, k, v, causal),
            flash.flash_attention_ref(q, k, v, causal), q, k, v, causal, T)
        got = flash.flash_attention_parts(q, k, v, causal)
        ref = flash.flash_attention_parts_ref(q, k, v, causal)
        _attn_check(torch, "K16 " + what + " m", got[0], ref[0])
        f64["K16 " + what] = _f64_check(
            torch, flash, "K16 " + what, _parts_out(got), _parts_out(ref),
            q, k, v, causal, T)
        n += 2
    p, T, H, D = ATTN_P, ATTN_T, ATTN_H, ATTN_D
    hl = H // p
    qh, kh, vh = (rnd((p, p * T, hl, D)) for _ in range(3))
    got = flash.flash_attention(qh, kh, vh, True)
    ref = flash.flash_attention_ref(qh, kh, vh, True)
    err15 = _attn_check(torch, "K15 Ulysses full width", got, ref)
    f64["K15"] = _f64_check(torch, flash, "K15 Ulysses full width", got,
                            ref, qh, kh, vh, True)
    del qh, kh, vh, got, ref
    q, k, v = (rnd((p, T, H, D)) for _ in range(3))
    err16 = 0.0
    for step, (blocks, causal) in enumerate((((q, k, v), True),
                                              ((q[1:], k[1:], v[1:]),
                                               False))):
        what = f"K16 ring step {step}"
        got = flash.flash_attention_parts(*blocks, causal)
        ref = flash.flash_attention_parts_ref(*blocks, causal)
        err16 = max(err16, _parts_check(torch, what, got, ref))
        f64[f"K16_step{step}"] = _f64_check(
            torch, flash, what, _parts_out(got), _parts_out(ref), *blocks,
            causal)
        del got, ref
    n += 3
    # TF32 products must fail the f32 tolerance, or it could not tell
    # the kernel's f32 arithmetic from TF32
    q, k, v = (rnd((1024, 4, D)) for _ in range(3))
    got = flash.flash_attention(q, k, v, True)
    _set_f32_matmul(torch, True)
    tf32 = flash.flash_attention_ref(q, k, v, True)
    _set_f32_matmul(torch, False)
    tf32_err = (got - tf32).abs().max().item()
    if torch.allclose(got, tf32, **ATTN_TOL):
        raise AssertionError(f"the TF32 plain version falls inside the f32 "
                             f"tolerance (max abs err {tf32_err}): the "
                             f"check cannot tell f32 from TF32")
    log(f"[kernels] flash: {n} checks of K15/K16 against their plain "
        f"versions (f32 rtol {ATTN_TOL['rtol']} atol {ATTN_TOL['atol']}, "
        f"one ulp more in bf16/f16; {2 * len(SHARP_CASES)} with q and k "
        f"x{ATTN_SHARP:g}, held against f64); full width K15 err "
        f"{err15:.3g}, K16 {err16:.3g}; against f64 attention (the last "
        f"{ATTN_SAMPLE} rows a head row at full width, every row of the "
        f"sharp cases; kernel / plain): "
        + ", ".join(f"{w} {a:.3g} / {b:.3g}" for w, (a, b) in f64.items())
        + f"; the TF32 plain version is off by {tf32_err:.3g}, outside the "
        f"tolerance")
    return {"K15": err15, "K16": err16, "tf32_err": tf32_err,
            "f64_err": {w: {"kernel": a, "plain": b}
                        for w, (a, b) in f64.items()}}


def _parts_out(parts):
    """K16's (m, num, den) normalised: num / den, [B, T, H, D]."""
    return parts[1] / parts[2].transpose(-1, -2)[..., None]


def _f64_check(torch, flash, what, got, plain, q, k, v, causal,
               rows=None):
    """The last ``rows`` (ATTN_SAMPLE) query rows of each head row of ``got`` (the
    kernel) and ``plain`` (its plain version), [B, T, H, D] outputs of
    attention over [B, T, H, D] blocks at block-local positions, against
    attention in f64 on the same inputs (q scaled by the same f32
    D^-0.5). The kernel must lie within ATTN_TOL of it and its max error
    within ATTN_F64_FACTOR times the plain version's. Returns both max
    errors."""
    T, D = q.shape[1], q.shape[-1]
    lo = T - (rows or ATTN_SAMPLE)
    qq = q[:, lo:].double() * flash._scale(D)
    s = torch.einsum("bthd,bkhd->bhtk", qq, k.double())
    if causal:
        pq = torch.arange(lo, T, device=q.device)
        pk = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(pq[:, None] < pk[None, :], float("-inf"))
    want = torch.einsum("bhtk,bkhd->bthd", torch.softmax(s, -1), v.double())
    del s
    got, plain = got[:, lo:].double(), plain[:, lo:].double()
    ek = (got - want).abs().max().item()
    ep = (plain - want).abs().max().item()
    if not torch.allclose(got, want, **ATTN_TOL) or \
            ek > ATTN_F64_FACTOR * ep:
        raise AssertionError(f"{what}: against f64 attention the kernel errs "
                             f"{ek}, the plain f32 version {ep} (limits: "
                             f"ATTN_TOL and {ATTN_F64_FACTOR:g}x the plain "
                             f"version's)")
    return ek, ep


def _dense_rows(torch, q, k, v, lo, hi):
    """Causal dense attention in f32 of the query rows [lo, hi) (global
    positions) against every key up to the last of them."""
    D = q.shape[-1]
    s = torch.einsum("thd,khd->htk", q[lo:hi], k[:hi]) * D ** -0.5
    pq = torch.arange(lo, hi, device=q.device)
    pk = torch.arange(hi, device=q.device)
    s = torch.where(pq[:, None] >= pk[None, :], s, -1e30)
    return torch.einsum("htk,khd->thd", torch.softmax(s, -1), v[:hi])


def attn_paths(comm, ra, ul):
    """The two sequence-parallel paths, each with the flash launches one
    call makes: (K15, K16)."""
    return {"ring": (lambda a, b, c: ra.ring_attention_flash(
                a, b, c, comm, causal=True), (0, comm.size)),
            "ulysses": (lambda a, b, c: ul.ulysses_attention(
                a, b, c, comm, causal=True, use_flash=True), (1, 0))}


def phase_attn(torch, flash, ra, ul, MeshComm, make_mesh, dev):
    """Both sequence-parallel attention paths at Ouro-2.6B's attention
    width (16 heads x 128, f32, causal) over 8 virtual ranks of 4096
    tokens, through MeshComm.run: ring_attention_flash (K16, 8 launches
    a call) and ulysses_attention(use_flash=True) (K15, one launch). The
    flash counts are zeroed just before each path's first call and read
    just after. Ring against Ulysses over every row; both against dense
    f32 attention on the last ATTN_SAMPLE rows of each rank; then the
    host-clock latency, median of 5 after 1."""
    _set_f32_matmul(torch, False)
    comm = MeshComm(make_mesh((ATTN_P,), ("sp",), dev))
    gen = torch.Generator(device=dev).manual_seed(SEED + 1700)
    tg = ATTN_P * ATTN_T
    q, k, v = (torch.randn((tg, ATTN_H, ATTN_D), generator=gen, device=dev)
               for _ in range(3))
    outs, lat, launches = {}, {}, {}
    for name, (fn, (k15, k16)) in attn_paths(comm, ra, ul).items():
        torch.cuda.synchronize()
        flash.reset_counts()
        out = comm.run(fn, q, k, v)
        torch.cuda.synchronize()
        launches[name] = dict(flash.LAUNCHES)
        if launches[name] != {"flash_attention": k15,
                              "flash_attention_parts": k16} or \
                any(flash.PLAIN_CALLS.values()):
            raise AssertionError(f"[attn] {name}: launches "
                                 f"{launches[name]}, plain "
                                 f"{flash.PLAIN_CALLS}")
        if out.shape != q.shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"[attn] {name}: output {tuple(out.shape)} "
                                 f"or non-finite")
        outs[name] = out
        ts = []
        for _ in range(6):
            t0 = time.perf_counter()
            comm.run(fn, q, k, v)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        lat[name] = ts[1:]
    agree = (outs["ring"] - outs["ulysses"]).abs().max().item()
    if not torch.allclose(outs["ring"], outs["ulysses"], **ATTN_TOL):
        raise AssertionError(f"[attn] ring and Ulysses disagree ({agree})")
    dense_err = {"ring": 0.0, "ulysses": 0.0}
    for r in range(ATTN_P):
        lo, hi = (r + 1) * ATTN_T - ATTN_SAMPLE, (r + 1) * ATTN_T
        want = _dense_rows(torch, q, k, v, lo, hi)
        for name, out in outs.items():
            got = out[lo:hi]
            dense_err[name] = max(dense_err[name],
                                  (got - want).abs().max().item())
            if not torch.allclose(got, want, **ATTN_TOL):
                raise AssertionError(f"[attn] {name}: rank {r}'s last "
                                     f"rows disagree with dense attention")
    med = {n: statistics.median(t) for n, t in lat.items()}
    log(f"[attn] 8 ranks x {ATTN_T} tokens, {ATTN_H} heads x {ATTN_D}, f32, "
        f"causal: launches {launches}; ring vs Ulysses max abs err "
        f"{agree:.3g}; vs dense on {ATTN_SAMPLE} rows a rank {dense_err}; "
        + "; ".join(f"{n} {med[n] * 1e3:.3f} ms a call "
                    f"({tg / med[n]:.0f} tokens/s)" for n in med))
    return launches, lat, (q, k, v, comm)


def _ring_k16_launches(flash, q, k, v):
    """The K16 launches of one causal ring call on fixed blocks: the
    diagonal step over every rank, then step s over ranks [s, p)."""
    flash.flash_attention_parts(q, k, v, True)
    for s in range(1, q.shape[0]):
        flash.flash_attention_parts(q[s:], k[s:], v[s:], False)


def phase_attn_times(torch, flash, ul, coll, timing, info, launches, lat,
                     full_err, data):
    """K15 (Ulysses' launch) and K16 (the ring's first past step, 7 ranks,
    and one call's 8 launches) by CUDA events, median of 5 after 1 (plain
    versions 3 after 1), beside the bound and the library yardstick:
    scaled_dot_product_attention (memory-efficient backend) on the same
    f32 blocks, causal for K15, non-causal for K16's step (it gives the
    normalised output, not the parts: for scale). The bound is the
    arithmetic the kernels run, three TF32 products a multiply-add at
    TF32_PEAK_TFLOPS (or the bytes, if longer); ``f32_bound_ms`` is one
    f32 product at F32_PEAK_TFLOPS on the CUDA cores."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    _set_f32_matmul(torch, False)
    bw = info.hbm_bw_gbps * 1e9
    q, k, v, comm = data
    p, T, H, D = ATTN_P, ATTN_T, ATTN_H, ATTN_D
    tg = p * T

    def bound(nbytes, flops):
        tb = nbytes / bw * 1e3
        to = 3 * flops / (TF32_PEAK_TFLOPS * 1e12) * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    def f32_bound(flops):
        return flops / (F32_PEAK_TFLOPS * 1e12) * 1e3

    def heads_major(x):
        return x.permute(0, 2, 1, 3)           # [B, H, T, D] view

    # K15 on the Ulysses reshard: p ranks x H/p heads x all tokens
    qh, kh, vh = (ul._seq_to_heads(comm.shard(x), comm) for x in (q, k, v))
    k15 = timing.time_ms(lambda: flash.flash_attention(qh, kh, vh, True),
                         warmup=1, iters=5)
    k15_plain = timing.time_ms(
        lambda: flash.flash_attention_ref(qh, kh, vh, True), warmup=1,
        iters=3)
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        k15_lib = timing.time_ms(lambda: sdpa(
            heads_major(qh), heads_major(kh), heads_major(vh),
            is_causal=True), warmup=1, iters=5)
    pairs = tg * (tg + 1) // 2 * H                 # (query, key) kept
    k15_b, k15_by = bound(4 * tg * H * D * 4, 4 * D * pairs)
    del qh, kh, vh
    # K16 on the ring's step 1: ranks 1..7 against their left neighbour
    qs = comm.shard(q)
    ks, vs = (coll.ring_shift(comm.shard(x), comm, 1) for x in (k, v))
    q1, k1, v1 = qs[1:], ks[1:], vs[1:]
    k16 = timing.time_ms(
        lambda: flash.flash_attention_parts(q1, k1, v1, False), warmup=1,
        iters=5)
    k16_plain = timing.time_ms(
        lambda: flash.flash_attention_parts_ref(q1, k1, v1, False),
        warmup=1, iters=3)
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        k16_lib = timing.time_ms(lambda: sdpa(
            heads_major(q1), heads_major(k1), heads_major(v1)), warmup=1,
            iters=5)
    n1 = (p - 1) * T * H * D * 4
    k16_b, k16_by = bound(4 * n1 + 2 * (p - 1) * H * T * 4,
                          4 * D * (p - 1) * H * T * T)
    k16_call = timing.time_ms(lambda: _ring_k16_launches(flash, qs, ks, vs),
                              warmup=1, iters=3)
    k16_call_b, _ = bound(0, 4 * D * pairs)
    f32_b = {"K15": f32_bound(4 * D * pairs),
             "K16": f32_bound(4 * D * (p - 1) * H * T * T),
             "call": f32_bound(4 * D * pairs)}
    del q1, k1, v1, qs, ks, vs
    e2e = {n: statistics.median(t) * 1e3 for n, t in lat.items()}
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "mvapich2_tpu_torch/csrc/flash.cu",
         "replaces": "mvapich2_tpu/models/flash.py:121",
         "launches": launches["ulysses"]["flash_attention"],
         "max_abs_err": full_err["K15"], "ms": k15, "plain_ms": k15_plain,
         "bound_ms": k15_b, "bound_by": k15_by, "library_ms": k15_lib,
         "f32_bound_ms": f32_b["K15"]},
        {"name": "flash_attention_parts", "route": "cuda",
         "source": "mvapich2_tpu_torch/csrc/flash.cu",
         "replaces": "mvapich2_tpu/models/flash.py:157",
         "launches": launches["ring"]["flash_attention_parts"],
         "max_abs_err": full_err["K16"], "ms": k16, "plain_ms": k16_plain,
         "bound_ms": k16_b, "bound_by": k16_by, "library_ms": k16_lib,
         "f32_bound_ms": f32_b["K16"]},
    ]
    extra = {"attn_e2e_ms": e2e,
             "attn_e2e_ms_all": {n: [t * 1e3 for t in ts]
                                 for n, ts in lat.items()},
             "attn_tokens_per_s": {n: tg / (t * 1e-3)
                                   for n, t in e2e.items()},
             "k16_ring_call_ms": k16_call, "k16_ring_call_bound_ms":
             k16_call_b, "k16_ring_call_f32_bound_ms": f32_b["call"],
             "k15_peak_share": k15_b / k15, "k16_peak_share": k16_b / k16,
             "tf32_plain_err": full_err["tf32_err"],
             "attn_f64_err": full_err["f64_err"]}
    log(f"[times] K15 (Ulysses, {p} x {H // p} heads x {tg} tokens) "
        f"{k15:.3f} ms (bound {k15_b:.3f} {k15_by}: 3 TF32 products at "
        f"{TF32_PEAK_TFLOPS:g} TFLOP/s; f32 bound {f32_b['K15']:.3f}, plain "
        f"{k15_plain:.3f}, SDPA {k15_lib:.3f}); K16 step 1 ({p - 1} ranks x "
        f"{H} heads x {T}^2) {k16:.3f} ms (bound {k16_b:.3f} {k16_by}, f32 "
        f"bound {f32_b['K16']:.3f}, plain {k16_plain:.3f}, SDPA "
        f"{k16_lib:.3f}); K16 a ring call {k16_call:.3f} ms (bound "
        f"{k16_call_b:.3f}, f32 bound {f32_b['call']:.3f}); e2e ring "
        f"{e2e['ring']:.3f} ms, Ulysses {e2e['ulysses']:.3f} ms")
    return kernels, extra


def _attn_group(name):
    name = name.lower()
    if "flash_kernel" in name:
        return "kernel"
    if "roll" in name:
        return "shift"
    if "copy" in name:
        return "copy"
    return "merge"


def phase_attn_profile(torch, ra, ul, lat, data):
    """One call of each path under torch.profiler: device time by group
    (kernel: K15/K16; shift: the ring's torch.roll of K/V; copy: kernels
    named copy, the Ulysses reshards; merge: the rest, the streaming
    merge's elementwise ops, fills and slice writes), and the idle share
    against the
    unprofiled median call (1 - busy / median). Run last, as the other
    profiles."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v, comm = data
    split = {}
    for name, (fn, _) in attn_paths(comm, ra, ul).items():
        comm.run(fn, q, k, v)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            comm.run(fn, q, k, v)
            torch.cuda.synchronize()
        groups = {"kernel": 0.0, "shift": 0.0, "copy": 0.0, "merge": 0.0}
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                groups[_attn_group(ev.key)] += ev.self_device_time_total
        busy = sum(groups.values())
        if not groups["kernel"]:
            # every call launches K15 or K16: a profile without them
            # lost the kernel's record, and its idle share would be false
            split[name] = ("not measured (the profiler recorded no flash "
                           f"kernel; {busy:.0f} us of other device time)")
            continue
        split[name] = {**groups, "busy_us": busy, "idle_share":
                       1 - busy / (statistics.median(lat[name]) * 1e6)}
    log(f"[attn] device time a call, us (torch.profiler): {split}")
    return split


# kernel name -> group; K4 runs as ring_reduce_scatter_direct_kernel, K3
# as ring_all_reduce_direct_kernel, which it shares with K6 (no K6 runs
# on a 64 MiB call)
HIER_GROUPS = (("slot_reduce", "K1"), ("ring_reduce_scatter", "K4"),
               ("ring_all_gather", "K5"), ("ring_all_reduce_direct", "K3"),
               ("CatArrayBatchedCopy", "stack"))


def phase_hier_profile(torch, mvt, dev, inputs, lat):
    """One 64 MiB f32 allreduce on each of the slot channel, the 1-D
    mesh, the 4-device fold and the (2, 4) mesh, each under
    torch.profiler (rank threads included): device time by kernel (K1,
    K3, K4, K5, the staging stacks; other: the copies and fills around
    them), and the idle share against the path's unprofiled median call
    (1 - busy / median). Run last, as the other profiles."""
    from torch.profiler import ProfilerActivity, profile
    meshes = {"slot": None, "mesh_1d": ((R,), ("x",)),
              "fold": ((4,), ("x",)), "mesh2d": ((2, 4), ("x", "y"))}
    split = {}
    for name, geometry in meshes.items():
        mesh = geometry and mvt.make_mesh(*geometry, dev)

        def app(comm):
            comm.allreduce(inputs[comm.rank])
            torch.cuda.current_stream().synchronize()
        mvt.run_ranks(R, app, device_mesh=mesh)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            mvt.run_ranks(R, app, device_mesh=mesh)
            torch.cuda.synchronize()
        groups = dict.fromkeys([g for _, g in HIER_GROUPS] + ["other"], 0.0)
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                g = next((g for k, g in HIER_GROUPS if k in ev.key),
                         "other")
                groups[g] += ev.self_device_time_total
        busy = sum(groups.values())
        if not busy:
            split[name] = "not measured (no device activity profiled)"
            continue
        split[name] = {**groups, "busy_us": busy, "idle_share":
                       1 - busy / (statistics.median(lat[name]) * 1e6)}
    log(f"[hier] device time of one 64 MiB allreduce, us (torch.profiler):"
        f" {split}")
    m2 = split["mesh2d"]
    if isinstance(m2, dict):
        log(f"[hier] (2, 4) call: K4 {m2['K4']:.1f} us over its two "
            f"phases, K5 {m2['K5']:.1f}, busy {m2['busy_us']:.1f}, idle "
            f"share {m2['idle_share']:.3f}")
    for name in ("slot", "fold"):
        g = split[name]
        if isinstance(g, dict):
            log(f"[hier] {name} call: K1 {g['K1']:.1f} us, staging stacks "
                f"{g['stack']:.1f}, busy {g['busy_us']:.1f}, idle share "
                f"{g['idle_share']:.3f}")
    return split


def phase_sweep(torch, ici, quant, ring, tuning, timing, _build, dev):
    """K9's launch shape (``--sweep``): the whole quant_ring_all_reduce
    (one direct K9 launch) at 8 ranks x 64 MiB f32 on the q8 wire, over
    threads per block x source loads a lane has in flight before it
    folds them, by CUDA events (median of 10 after 2 warm-ups). The loads
    in flight are the compile-time ``kQuantGroup`` of ``csrc/ring.cu``:
    each count is a copy of the source with that constant edited, built
    at once (one nvcc each, ``bench/k8_ablation.build``) and bound in
    place of the built library. Every shape's result rows and wire
    outputs are first held bitwise against the plain version's. Restores
    the compiled-in shape and library. Returns the rows."""
    import itertools
    from concurrent.futures import ThreadPoolExecutor
    from mvapich2_tpu_torch.bench import k8_ablation as abl
    base = (_build.CSRC_DIR / "ring.cu").read_text()
    found = re.findall(r"constexpr int kQuantGroup = (\d+);", base)
    if len(found) != 1:
        raise AssertionError(f"K9 sweep: kQuantGroup is defined "
                             f"{len(found)} times in ring.cu")
    anchor = f"constexpr int kQuantGroup = {found[0]};"
    folder = _build.BUILD_DIR.parent / "k9_sweep"
    loads = (1, 2, 4, 8)
    with ThreadPoolExecutor(len(loads)) as pool:
        paths = dict(zip(loads, pool.map(
            lambda g: abl.build(f"loads{g}", base.replace(
                anchor, f"constexpr int kQuantGroup = {g};"), folder),
            loads)))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = [torch.randn(N, generator=gen, device=dev) for _ in range(R)]
    ndir = ici._resolve_ndir(R, None)
    blk, nblk = quant._geometry(R, N, None)
    want_w = quant.quant_reduce_scatter_ref(x, nblk, blk, "q8", ndir)[0]
    want = quant.quant_ring_all_reduce_ref(x, wire="q8")
    keep = tuning.kernel_param("quant_threads", 128)
    saved = _build._loaded.get("ring")
    rows = []
    try:
        for g, threads in itertools.product(loads, (128, 256, 512)):
            _build._loaded["ring"] = abl._bind(paths[g])
            tuning.set_kernel_param("quant_threads", threads)

            def fn():
                return quant.quant_ring_all_reduce(x, wire="q8")
            got, wires = fn(), quant.quant_reduce_scatter(x, nblk, blk,
                                                          "q8", ndir)
            ring.check_errors()
            if not (torch.equal(got, want) and torch.equal(wires, want_w)):
                raise AssertionError(f"K9 threads={threads} loads={g}: "
                                     f"kernel and plain version disagree")
            rows.append({"kernel": "K9", "threads": threads, "loads": g,
                         "ms": timing.time_ms(fn, warmup=2, iters=10)})
            log(f"[sweep] {rows[-1]}")
    finally:
        tuning.set_kernel_param("quant_threads", keep)
        if saved is None:
            _build._loaded.pop("ring", None)
        else:
            _build._loaded["ring"] = saved
    best = min(rows, key=lambda r: r["ms"])
    log(f"[sweep] K9 fastest: {best} (compiled in: threads {keep}, "
        f"loads {found[0]})")
    del x, want, want_w
    return rows


def phase_copy_sweep(torch, rma, tuning, timing, dev):
    """The launch-shape sweep of the K12/K13 direct copy (``--sweep``):
    threads per block at the path's shapes: K12 and K13 of N f32
    elements at disp 0, K12 of N - 7 at disp 5 and of 4N - 3 i8 elements at disp 1 (misaligned),
    by CUDA events (median of 20 after 3), each first held bitwise
    against the plain version, with copy_ on the same tensors beside.
    Restores the compiled-in shape. Returns the rows."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1200)
    win = torch.randn(R, N, generator=gen, device=dev)
    src = torch.randn(N, generator=gen, device=dev)
    out = torch.empty_like(src)
    win8, src8 = win.view(torch.int8), src.view(torch.int8)
    m, m8, t = N - 7, 4 * N - 3, R - 1
    cases = {
        "put f32 disp 0": (lambda: rma.rma_put(src, win, 0, t),
                           lambda: win[t].copy_(src),
                           lambda: torch.equal(win[t], src)),
        "get f32 disp 0": (lambda: rma.rma_get(win, N, 0, t),
                           lambda: out.copy_(win[t]), None),
        "put f32 disp 5": (lambda: rma.rma_put(src[:m], win, 0, t, 5),
                           lambda: win[t, 5:5 + m].copy_(src[:m]),
                           lambda: torch.equal(win[t, 5:5 + m], src[:m])),
        "put i8 disp 1": (lambda: rma.rma_put(src8[:m8], win8, 0, t, 1),
                          lambda: win8[t, 1:1 + m8].copy_(src8[:m8]),
                          lambda: torch.equal(win8[t, 1:1 + m8],
                                              src8[:m8])),
    }
    keep = tuning.kernel_param("rma_copy_threads", 256)
    rows = []
    for threads in (128, 256, 512, 1024):
        tuning.set_kernel_param("rma_copy_threads", threads)
        for case, (fn, lib, ok) in cases.items():
            got = fn()
            torch.cuda.synchronize()
            if ok is None:
                ok = (lambda g=got: torch.equal(g, win[t]))
            if not ok():
                raise AssertionError(f"copy sweep {case} threads={threads}:"
                                     f" kernel and plain version disagree")
            rows.append({"kernel": "K12/K13 " + case, "threads": threads,
                         "ms": timing.time_ms(fn),
                         "library_ms": timing.time_ms(lib)})
            log(f"[sweep] {rows[-1]}")
    tuning.set_kernel_param("rma_copy_threads", keep)
    return rows


def phase_tile_sweep(torch, a2a, moe, ring, timing, dev):
    """K11's tile size (``--sweep``): the MoE dispatch at 4096 x 4096 f32
    of each routing, with ``alltoall.TILE_BYTES`` set to 32 KiB .. 1 MiB
    in turn, each first held bitwise against the plain version, then
    timed by CUDA events and by card time. Restores the constant.
    Returns the rows."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1300)
    keep = a2a.TILE_BYTES
    rows = []
    for shape in ("hot", "skew", "uniform"):
        counts = _moe_counts(moe, shape)
        vs = [torch.randn(sum(counts[r]), generator=gen, device=dev)
              for r in range(R)]
        want = a2a.hbm_alltoallv_ref(vs, counts)
        for kib in (32, 64, 128, 256, 512, 1024):
            a2a.TILE_BYTES = kib << 10
            got = a2a.hbm_alltoallv(vs, counts)
            torch.cuda.synchronize()
            ring.check_errors()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"tile sweep {shape} {kib} KiB: kernel "
                                     f"and plain version disagree")

            def kern():
                return a2a.hbm_alltoallv(vs, counts)

            rows.append({"kernel": f"K11 {shape}", "tile_kib": kib,
                         "ms": timing.time_ms(kern),
                         "card_ms": _queued_ms(torch, kern)})
            log(f"[sweep] {rows[-1]}")
        del vs, want, got
    a2a.TILE_BYTES = keep
    return rows


def phase_k8_sweep(torch, ici, ring, tuning, timing, dev):
    """K8's launch shape (``--sweep``): bytes a tile x shared-memory
    stages x tiles loaded ahead x blocks per SM, at 8 x 64 MiB f32 (2 <->
    5), each first held bitwise against the plain version, then timed by
    CUDA events and by card time; torch.stack by partner beside it.
    Restores the compiled-in shape. Returns the rows."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1400)
    xs = [torch.randn(N, generator=gen, device=dev) for _ in range(R)]
    part = list(range(R))
    part[2], part[5] = 5, 2

    def lib():
        return torch.stack([xs[j] for j in part])

    want = lib()
    rows = [{"kernel": "K8 library: torch.stack by partner",
             "ms": timing.time_ms(lib), "card_ms": _queued_ms(torch, lib)}]
    log(f"[sweep] {rows[-1]}")
    keys = ("k8_tile_bytes", "k8_stages", "k8_ahead", "k8_ctas_per_sm")
    keep = {k: tuning.kernel_param(k, 0) for k in keys}
    for kib in (16, 32, 64):
        for stages in (2, 4, 6, 8):
            if stages * kib > 192:
                continue
            for ahead in sorted({1, stages // 2, stages - 1}):
                for ctas in (1, 2):
                    for k, v in zip(keys, (kib << 10, stages, ahead, ctas)):
                        tuning.set_kernel_param(k, v)

                    def kern():
                        return ici.remote_sendrecv(xs, 2, 5)

                    got = kern()
                    torch.cuda.synchronize()
                    ring.check_errors()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"K8 sweep {kib} KiB x {stages} stages, ahead "
                            f"{ahead}, {ctas} a SM: kernel and plain version"
                            f" disagree")
                    rows.append({"kernel": "K8", "tile_kib": kib,
                                 "stages": stages, "ahead": ahead,
                                 "ctas_per_sm": ctas,
                                 "ms": timing.time_ms(kern),
                                 "card_ms": _queued_ms(torch, kern)})
                    log(f"[sweep] {rows[-1]}")
    for k, v in keep.items():
        tuning.set_kernel_param(k, v)
    return rows


def phase_k1_sweep(torch, hbm, tuning, timing, dev):
    """K1's pointer form (``--sweep``): threads a block x blocks per SM
    over 8 deposits of 64 MiB f32, each first held bitwise against the
    plain version, then timed by CUDA events and by card time; torch.sum
    of the stacked deposits and torch.stack(deposits).sum(0) beside it.
    Restores the compiled-in shape. Returns the rows."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1500)
    xs = [torch.randn(N, generator=gen, device=dev) for _ in range(R)]
    x = torch.stack(xs)
    want = hbm.hbm_slot_allreduce_ref(xs)
    rows = []
    for name, fn in (("torch.sum of the stacked", lambda: torch.sum(x, 0)),
                     ("torch.stack(deposits).sum(0)",
                      lambda: torch.stack(xs).sum(0))):
        rows.append({"kernel": f"K1 library: {name}",
                     "ms": timing.time_ms(fn),
                     "card_ms": _queued_ms(torch, fn)})
        log(f"[sweep] {rows[-1]}")
    keys = ("hbm_slot_threads", "hbm_slot_blocks_per_sm")
    keep = {k: tuning.kernel_param(k, 0) for k in keys}
    for threads in (128, 256, 512, 1024):
        for per_sm in (1, 2, 4, 8, 16):
            if threads * per_sm > 2048:
                continue
            tuning.set_kernel_param(keys[0], threads)
            tuning.set_kernel_param(keys[1], per_sm)

            def kern():
                return hbm.hbm_slot_allreduce(xs)

            if not torch.equal(kern(), want):
                raise AssertionError(f"K1 sweep {threads} x {per_sm}: "
                                     f"kernel and plain version disagree")
            rows.append({"kernel": "K1 pointer form", "threads": threads,
                         "blocks_per_sm": per_sm,
                         "ms": timing.time_ms(kern),
                         "card_ms": _queued_ms(torch, kern)})
            log(f"[sweep] {rows[-1]}")
    for k, v in keep.items():
        tuning.set_kernel_param(k, v)
    return rows


SWEEPS = ("k9", "copy", "tile", "k8", "k1")


# -- [host]: the in-process host tier ------------------------------------
HOST_SIZES = (4, 1024, 16 * 1024 - 4, 16 * 1024, 64 * 1024,
              64 * 1024 * 1024)        # allreduce bytes a rank
HOST_LAT_SIZES = (4, 64, 1024, 4096, 16 * 1024 - 4)
HOST_ITERS = 50                        # timed iterations a latency
HOST_WARM = 5
PINGPONG_MAX = 4 * 1024 * 1024
PINGPONG_ITERS = 20
HOST_RD = "coll_allreduce_allreduce_recursive_doubling_calls"


def _host_data(np, r, n, dtype="float32"):
    """Rank r's integer-valued buffer of n elements: sums of 8 ranks
    stay exact in f32, so every result compares bitwise."""
    return ((np.arange(n, dtype=np.int64) * (r + 3)) % 61 - 30).astype(dtype)


def _pv(mpit, name):
    return mpit.pvar(name).read()


def _median_us(samples):
    return statistics.median(samples) * 1e6


def phase_host_sweep(torch, np, mvt, mods, mpit, dev):
    """numpy f32 allreduces across the host-device crossover on the slot
    channel and the 1:1 mesh: below DEVICE_COLL_MIN_BYTES no kernel
    launches and the recursive-doubling counter moves once a rank; at and
    above it K1 (slot) or K6/K3 (mesh) launch once a call, as before this
    tier existed. Every result bitwise against numpy."""
    hbm, ici, ring = mods[0], mods[1], mods[2]
    rows = []
    for chan in ("slot", "mesh"):
        kw = {"device": dev} if chan == "slot" else {
            "device_mesh": mvt.make_mesh((R,), ("x",), dev)}
        for nbytes in HOST_SIZES:
            n = nbytes // 4
            data = [_host_data(np, r, n) for r in range(R)]
            want = np.sum(data, axis=0, dtype=np.float32)
            host = nbytes < 16 * 1024
            _zero(*mods)
            rd0 = _pv(mpit, HOST_RD)
            t0 = time.perf_counter()
            res = mvt.run_ranks(R, lambda comm: comm.allreduce(
                data[comm.rank]), **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _launches(*mods)
            rd = _pv(mpit, HOST_RD) - rd0
            if host:
                want_l = _want(mods)
            elif chan == "slot":
                want_l = _want(mods, fused_reduce_to_slot=1)
            elif nbytes <= 4 * 1024 * 1024:
                want_l = _want(mods, ring_all_reduce=1)
            else:
                want_l = _want(mods, hbm_ring_all_reduce=1)
            if got != want_l or rd != (R if host else 0):
                raise AssertionError(
                    f"[host] {chan} allreduce of {nbytes} B: launches "
                    f"{ {k: v for k, v in got.items() if v} }, rd calls "
                    f"{rd}; expected { {k: v for k, v in want_l.items() if v} }"
                    f" and {R if host else 0}")
            for r, out in enumerate(res):
                if out.dtype != np.float32 or \
                        out.tobytes() != want.tobytes():
                    raise AssertionError(f"[host] {chan} allreduce of "
                                         f"{nbytes} B: rank {r} differs "
                                         f"from numpy")
            rows.append({"channel": chan, "bytes": nbytes,
                         "tier": "host" if host else "device",
                         "launches": {k: v for k, v in got.items() if v},
                         "rd_calls": rd, "wall_s": wall})
            del data, res
    log("[host] allreduce crossover, numpy f32 integer-valued, bitwise "
        "against numpy: " + "; ".join(
            f"{r['channel']} {r['bytes']} B {r['tier']} "
            f"{r['launches'] or 'no launch'} rd+{r['rd_calls']}"
            for r in rows))
    return rows


def _matmul_op(np, opmod):
    def f(invec, inout):
        a = invec.reshape(-1, 2, 2)
        b = inout.reshape(-1, 2, 2)
        return np.matmul(a, b).reshape(invec.shape)
    return opmod.create_op(f, commute=False)


def phase_host_calls(torch, np, mvt, mods, mpit, opmod, cfg, dev):
    """The calls the host tier carries on the slot channel (f64 at 1 MiB,
    a non-commutative user op, gather(v)/scatter(v)/scan/exscan/
    allgatherv/reduce_scatter, ibarrier/ireduce/ireduce_scatter_block/
    iallreduce, a 7-sender ANY_SOURCE receive, a barrier), a forced
    MV2T_ALLREDUCE_ALGO=ring at 64 KiB and alltoall on the fold channel:
    no kernel launches, every result against numpy."""
    from mvapich2_tpu_torch.core.request import waitall
    from mvapich2_tpu_torch.core.status import ANY_SOURCE, ANY_TAG
    op_mm = _matmul_op(np, opmod)
    counts = [(3 * k + 1) % 5 for k in range(R)]
    displs = [sum(counts[:k]) for k in range(R)]
    total = sum(counts)
    f64_n = (1 << 20) // 8

    def app(comm):
        r, p = comm.rank, comm.size
        out = {}
        out["f64"] = comm.allreduce(_host_data(np, r, f64_n, "float64"))
        m = np.tile(np.array([1.0, r + 1, 0.0, 1.0]), 4)
        out["noncomm"] = comm.allreduce(m, op=op_mm)
        out["gather"] = comm.gather(_host_data(np, r, 5, "int32"), root=3)
        sc = np.zeros(6, np.int32)
        comm.scatter(np.arange(6 * p, dtype=np.int32) if r == 2 else None,
                     sc, root=2)
        out["scatter"] = sc
        gv = np.zeros(total, np.int32) if r == 0 else None
        comm.gatherv(np.full(counts[r], r + 1, np.int32), gv, counts,
                     displs, root=0)
        out["gatherv"] = gv
        sv = np.zeros(counts[r], np.int32)
        comm.scatterv(np.arange(total, dtype=np.int32) if r == 1 else None,
                      counts, displs, sv, root=1)
        out["scatterv"] = sv
        out["scan"] = comm.scan(_host_data(np, r, 33))
        ex = np.zeros(33, np.float32)
        comm.exscan(_host_data(np, r, 33), ex)
        out["exscan"] = ex
        agv = np.zeros(total, np.int32)
        comm.allgatherv(np.full(counts[r], r + 7, np.int32), agv, counts,
                        displs)
        out["allgatherv"] = agv
        out["reduce_scatter"] = comm.reduce_scatter(
            _host_data(np, r, 4 * p), counts=[4] * p)
        ia = np.zeros(100, np.float32)
        ir = np.zeros(100, np.float32)
        irs = np.zeros(10, np.float32)
        reqs = [comm.ibarrier(),
                comm.ireduce(_host_data(np, r, 100), ir, root=0),
                comm.ireduce_scatter_block(_host_data(np, r, 10 * p), irs),
                comm.iallreduce(_host_data(np, r, 100), ia)]
        waitall(reqs)
        out["ireduce"], out["irsb"], out["iallreduce"] = ir, irs, ia
        if r == 0:
            seen, buf = [], np.zeros(1, np.int32)
            for _ in range(p - 1):
                st = comm.recv(buf, source=ANY_SOURCE, tag=ANY_TAG)
                if buf[0] != st.source * 100 + st.tag:
                    raise AssertionError("[host] ANY_SOURCE payload")
                seen.append(st.source)
            out["any_source"] = sorted(seen)
        else:
            comm.send(np.array([r * 100 + r], np.int32), dest=0, tag=r)
        comm.barrier()
        return out

    _zero(*mods)
    fb0 = _pv(mpit, "dev_coll_fallback_nbc")
    gb0 = _pv(mpit, "coll_allreduce_allreduce_gather_bcast_calls")
    t0 = time.perf_counter()
    res = mvt.run_ranks(R, app, device=dev)
    wall = time.perf_counter() - t0
    if any(_launches(*mods).values()):
        raise AssertionError(f"[host] host-tier calls launched "
                             f"{_launches(*mods)}")
    d = [_host_data(np, r, f64_n, "float64") for r in range(R)]
    mm = np.eye(2)
    for r in range(R):
        mm = mm @ np.array([[1.0, r + 1], [0.0, 1.0]])
    pre = [np.sum([_host_data(np, k, 33) for k in range(r + 1)], axis=0,
                  dtype=np.float32) for r in range(R)]
    rs_full = np.sum([_host_data(np, k, 4 * R) for k in range(R)], axis=0,
                     dtype=np.float32)
    irs_full = np.sum([_host_data(np, k, 10 * R) for k in range(R)],
                      axis=0, dtype=np.float32)
    sum100 = np.sum([_host_data(np, k, 100) for k in range(R)], axis=0,
                    dtype=np.float32)
    gv_want = np.concatenate([np.full(c, k + 1, np.int32)
                              for k, c in enumerate(counts)])
    agv_want = np.concatenate([np.full(c, k + 7, np.int32)
                               for k, c in enumerate(counts)])
    for r, o in enumerate(res):
        checks = [("f64", o["f64"], np.sum(d, axis=0)),
                  ("noncomm", o["noncomm"], np.tile(mm.reshape(-1), 4)),
                  ("scatter", o["scatter"], np.arange(6 * r, 6 * r + 6)),
                  ("scatterv", o["scatterv"],
                   np.arange(displs[r], displs[r] + counts[r])),
                  ("scan", o["scan"], pre[r]),
                  ("allgatherv", o["allgatherv"], agv_want),
                  ("reduce_scatter", o["reduce_scatter"],
                   rs_full[4 * r:4 * r + 4]),
                  ("irsb", o["irsb"], irs_full[10 * r:10 * r + 10]),
                  ("iallreduce", o["iallreduce"], sum100)]
        if r > 0:
            checks.append(("exscan", o["exscan"], pre[r - 1]))
        if r == 3:
            checks.append(("gather", o["gather"], np.concatenate(
                [_host_data(np, k, 5, "int32") for k in range(R)])))
        if r == 0:
            checks += [("gatherv", o["gatherv"], gv_want),
                       ("ireduce", o["ireduce"], sum100),
                       ("any_source", np.array(o["any_source"]),
                        np.arange(1, R))]
        for what, got, want in checks:
            if not np.array_equal(got, want):
                raise AssertionError(f"[host] {what} on rank {r}")
    fb = _pv(mpit, "dev_coll_fallback_nbc") - fb0
    gb = _pv(mpit, "coll_allreduce_allreduce_gather_bcast_calls") - gb0
    if fb != R or gb != R:
        raise AssertionError(f"[host] dev_coll_fallback_nbc +{fb}, "
                             f"gather_bcast calls +{gb}; expected {R}")

    # a forced host algorithm at 64 KiB, and alltoall on the fold channel
    ring_pv = "coll_allreduce_allreduce_ring_calls"
    n64 = 64 * 1024 // 4
    data = [_host_data(np, r, n64) for r in range(R)]
    want = np.sum(data, axis=0, dtype=np.float32)
    cfg.set("ALLREDUCE_ALGO", "ring")
    try:
        _zero(*mods)
        ring0 = _pv(mpit, ring_pv)
        res = mvt.run_ranks(R, lambda c: c.allreduce(data[c.rank]),
                            device=dev)
    finally:
        cfg.set("ALLREDUCE_ALGO", "")
    if any(_launches(*mods).values()) or \
            _pv(mpit, ring_pv) - ring0 != R or \
            any(o.tobytes() != want.tobytes() for o in res):
        raise AssertionError("[host] forced ring allreduce at 64 KiB")
    fold = mvt.make_mesh((R // 2,), ("x",), dev)
    _zero(*mods)
    res = mvt.run_ranks(R, lambda c: c.alltoall(
        np.arange(R * 3, dtype=np.float32) + 100 * c.rank), device_mesh=fold)
    if any(_launches(*mods).values()):
        raise AssertionError("[host] fold alltoall launched a kernel")
    for r, o in enumerate(res):
        want = np.concatenate([np.arange(r * 3, r * 3 + 3) + 100.0 * s
                               for s in range(R)])
        if not np.array_equal(o, want):
            raise AssertionError(f"[host] fold alltoall rank {r}")
    log(f"[host] slot channel: f64 1 MiB, non-commutative user op "
        f"(gather_bcast +{gb}), gather(v)/scatter(v)/scan/exscan/"
        f"allgatherv/reduce_scatter, ibarrier/ireduce/"
        f"ireduce_scatter_block/iallreduce (dev_coll_fallback_nbc "
        f"+{fb}), a 7-sender ANY_SOURCE receive and a barrier in "
        f"{wall:.2f} s; ALLREDUCE_ALGO=ring at 64 KiB (ring +{R}); fold "
        f"alltoall; no kernel launched, every result against numpy")
    return {"calls_wall_s": wall, "fallback_nbc": fb, "gather_bcast": gb}


def _pingpong(mvt, np, mpit, dev, nodes):
    """osu_latency's shape between ranks 0 and 1: half the round trip, a
    median over PINGPONG_ITERS after 2, and the eager/rendezvous pvar
    deltas of each size."""
    sizes = [1 << k for k in range(PINGPONG_MAX.bit_length())]

    def app(comm):
        out = []
        # no barrier between sizes: its tokens would count too. Rank 0
        # reads the pvars when rank 1 cannot be sending: before its own
        # first send of a size, and after its last receive
        for nb in sizes:
            buf = np.zeros(nb, np.uint8)
            msg = np.full(nb, 7, np.uint8)
            e0, r0 = (_pv(mpit, "pt2pt_eager_sent"),
                      _pv(mpit, "pt2pt_rndv_sent"))
            lat = []
            for it in range(2 + PINGPONG_ITERS):
                t0 = time.perf_counter()
                if comm.rank == 0:
                    comm.send(msg, dest=1, tag=1)
                    comm.recv(buf, source=1, tag=1)
                else:
                    comm.recv(buf, source=0, tag=1)
                    comm.send(msg, dest=0, tag=1)
                if it >= 2:
                    lat.append((time.perf_counter() - t0) / 2)
            if comm.rank == 0:
                if not (buf == 7).all():
                    raise AssertionError(f"[host] ping-pong {nb} B payload")
                out.append((nb, _median_us(lat),
                            _pv(mpit, "pt2pt_eager_sent") - e0,
                            _pv(mpit, "pt2pt_rndv_sent") - r0))
        return out

    return mvt.run_ranks(2, app, nodes=nodes, device=dev)[0]


def phase_host_latency(torch, np, mvt, mpit, cfg, smi, dev):
    """Host-clock latencies: the rank 0 <-> 1 ping-pong (1 B to 4 MiB) on
    two fake nodes, where the eager/rendezvous split must sit at
    EAGER_THRESHOLD (64 KiB), and on one node (SMP_EAGERSIZE, 32 KiB);
    then 8 ranks on the slot channel: barrier and allreduce at 4 B to
    16 KiB - 4 B (the host tier), medians over HOST_ITERS."""
    msgs = 2 * (2 + PINGPONG_ITERS)      # both ranks' sends a size
    res = {}
    for label, nodes, edge in (("two_nodes", [0, 1],
                                int(cfg["EAGER_THRESHOLD"])),
                               ("one_node", None, int(cfg["SMP_EAGERSIZE"]))):
        rows = _pingpong(mvt, np, mpit, dev, nodes)
        for nb, us, eager, rndv in rows:
            want = (msgs, 0) if nb <= edge else (0, msgs)
            if (eager, rndv) != want:
                raise AssertionError(
                    f"[host] ping-pong {label} {nb} B: eager +{eager}, "
                    f"rndv +{rndv}; expected {want} (split at {edge} B)")
        res[label] = rows
        log(f"[host] osu_latency shape, ranks 0 <-> 1 ({label}, eager up "
            f"to {edge} B, pvars checked), half round trip us (median of "
            f"{PINGPONG_ITERS}): " + ", ".join(
                f"{nb} B {us:.1f}" for nb, us, _, _ in rows) +
            f"; host clock on {smi}")

    def app(comm):
        out = {}
        for _ in range(HOST_WARM):
            comm.barrier()
        lat = []
        for _ in range(HOST_ITERS):
            t0 = time.perf_counter()
            comm.barrier()
            lat.append(time.perf_counter() - t0)
        out["barrier"] = _median_us(lat)
        for nb in HOST_LAT_SIZES:
            x = _host_data(np, comm.rank, nb // 4)
            y = np.empty_like(x)
            for _ in range(HOST_WARM):
                comm.allreduce(x, y)
            lat = []
            for _ in range(HOST_ITERS):
                t0 = time.perf_counter()
                comm.allreduce(x, y)
                lat.append(time.perf_counter() - t0)
            out[nb] = _median_us(lat)
        return out

    coll = mvt.run_ranks(R, app, device=dev)[0]
    res["barrier_us"] = coll["barrier"]
    res["allreduce_us"] = {nb: coll[nb] for nb in HOST_LAT_SIZES}
    log(f"[host] {R} ranks on the slot channel, rank 0's host clock, "
        f"median of {HOST_ITERS} after {HOST_WARM}: barrier "
        f"{coll['barrier']:.1f} us; allreduce (host tier, recursive "
        f"doubling) " + ", ".join(f"{nb} B {coll[nb]:.1f} us"
                                  for nb in HOST_LAT_SIZES) + f"; on {smi}")
    return res


def phase_host_refusals(torch, np, mvt, mods, cfg, dev):
    """Tensors on the card never take the host tier: each call that the
    device tier does not take raises NotImplementedError on every rank,
    with no kernel launch and no copy to the host (``to_host`` patched to
    fail while the calls run). Returns the cases checked."""
    from mvapich2_tpu_torch.coll import device as coll_dev
    from mvapich2_tpu_torch.core import comm as comm_mod
    n = 4096
    mesh = {"device_mesh": mvt.make_mesh((R,), ("x",), dev)}
    # 2 ranks a device: a split of ranks 0-2 (devices 0, 0, 1) and of 3-7
    # (1, 2, 2, 3, 3) binds no channel
    fold = {"device_mesh": mvt.make_mesh((R // 2,), ("x",), dev)}
    slot = {"device": dev}
    ones = [1] * R

    def t(dtype=torch.float32):
        return torch.ones(n, dtype=dtype, device=dev)
    cases = [
        ("f64 allreduce, slot", slot, "",
         lambda c: c.allreduce(t(torch.float64)), "float64"),
        ("ALLREDUCE_ALGO=ring, mesh", mesh, "ring",
         lambda c: c.allreduce(t()), "'ring' forced"),
        ("alltoallv in place, mesh", mesh, "", lambda c: c.alltoallv(
            comm_mod.IN_PLACE, ones, None, t()[:R], ones, None),
         "MPI_IN_PLACE"),
        ("allreduce on a split whose geometry binds nothing, fold", fold,
         "", lambda c: c.split(int(c.rank >= 3)).allreduce(t()),
         "no device channel"),
        ("iallreduce in place, slot", slot, "",
         lambda c: c.iallreduce(comm_mod.IN_PLACE, t()), "NBC tier"),
    ]

    def no_copy(x):
        raise AssertionError("a tensor on the card was copied to the host")
    real = coll_dev.to_host, comm_mod.to_host
    coll_dev.to_host = comm_mod.to_host = no_copy
    try:
        for what, kw, algo, call, names in cases:
            def app(comm):
                try:
                    call(comm)
                except NotImplementedError as e:
                    ok = names in str(e) and "not moved to the host" in str(e)
                    return str(e) if not ok else True
                return "returned"
            _zero(*mods)
            cfg.set("ALLREDUCE_ALGO", algo)
            try:
                res = mvt.run_ranks(R, app, **kw)
            finally:
                cfg.set("ALLREDUCE_ALGO", "")
            torch.cuda.synchronize()
            if res != [True] * R or any(_launches(*mods).values()):
                raise AssertionError(
                    f"[host] {what}: a tensor on the card gave {res[0]!r}, "
                    f"launches {_launches(*mods)}; expected "
                    f"NotImplementedError naming {names!r}, no launch")
    finally:
        coll_dev.to_host, comm_mod.to_host = real
    log(f"[host] tensors on the card that the device tier does not take "
        f"raise NotImplementedError on all {R} ranks, no launch, no copy "
        f"to the host: " + "; ".join(c[0] for c in cases))
    return [c[0] for c in cases]


def phase_host(torch, np, mvt, hbm, ici, ring, a2a, mpit, opmod, cfg, smi,
               dev):
    """The in-process host tier (module docstring, phase 15). Returns its
    figures."""
    t_phase = time.perf_counter()
    mods = (hbm, ici, ring, a2a)
    out = {"sweep": phase_host_sweep(torch, np, mvt, mods, mpit, dev)}
    out.update(phase_host_calls(torch, np, mvt, mods, mpit, opmod, cfg,
                                dev))
    out["refused_on_card"] = phase_host_refusals(torch, np, mvt, mods, cfg,
                                                 dev)
    out["latency"] = phase_host_latency(torch, np, mvt, mpit, cfg, smi, dev)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[host] phase {out['phase_s']:.1f} s on {smi}")
    return out


def phase_graft(torch, np, mods, smi, dev):
    """The graft entry (module docstring, phase 16): entry()'s forward on
    a (1, 1, 1) mesh of the card against the same forward on the CPU, and
    dryrun_multichip(8) against the same dry run on the CPU; both run
    stock torch (no kernel count moves)."""
    from mvapich2_tpu_torch import graft_entry
    t_phase = time.perf_counter()
    _zero(*mods)
    fwd, (params, tokens) = graft_entry.entry(dev)
    logits = fwd(params, tokens)
    torch.cuda.synchronize()
    fwd_cpu, _ = graft_entry.entry("cpu")      # the same forward, on the CPU
    cpu = fwd_cpu({k: v.cpu() for k, v in params.items()}, tokens.cpu())
    if tuple(logits.shape) != (4, 128, 128) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"[graft] entry forward {tuple(logits.shape)}")
    fwd_err = (logits.cpu() - cpu).abs().max().item()
    if not torch.allclose(logits.cpu(), cpu, **STEP_TOL):
        raise AssertionError(f"[graft] entry forward against the CPU: max "
                             f"abs err {fwd_err}")
    t0 = time.perf_counter()
    res = graft_entry.dryrun_multichip(R, dev)
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t0
    ref = graft_entry.dryrun_multichip(R, device="cpu")
    if res["mesh"] != (2, 2, 2) or not np.isfinite(res["loss"]):
        raise AssertionError(f"[graft] dryrun {res['mesh']} loss "
                             f"{res['loss']}")
    if abs(res["loss"] - ref["loss"]) > LOSS_RTOL * abs(ref["loss"]):
        raise AssertionError(f"[graft] dryrun loss {res['loss']} vs the "
                             f"CPU's {ref['loss']}")
    if not torch.allclose(res["pipeline_out"].cpu(), ref["pipeline_out"],
                          rtol=1e-5, atol=1e-6):
        raise AssertionError("[graft] dryrun pipeline against the CPU")
    if any(_launches(*mods).values()):
        raise AssertionError(f"[graft] launched {_launches(*mods)}: the "
                             f"entry runs stock torch")
    total = time.perf_counter() - t_phase
    log(f"[graft] entry() forward on (1, 1, 1): logits "
        f"{tuple(logits.shape)}, max abs err {fwd_err:.3g} against the "
        f"CPU; dryrun_multichip({R}): mesh {res['mesh']}, loss "
        f"{res['loss']!r} (CPU {ref['loss']!r}), pipeline out "
        f"{tuple(res['pipeline_out'].shape)}, {dry_s:.2f} s; phase "
        f"{total:.1f} s on {smi}")
    return {"entry_logits_max_abs_err": fwd_err, "dryrun_loss": res["loss"],
            "dryrun_cpu_loss": ref["loss"], "dryrun_s": dry_s,
            "phase_s": total}


MPIRUN_TIMEOUT = 300                     # seconds a job of [mpirun] may take
VPOD_PROG = os.path.join("mvapich2_tpu_torch", "progs",
                         "vpod_collectives.py")
PINGPONG_PROG = os.path.join("mvapich2_tpu_torch", "progs", "pingpong.py")
# the shared-memory rendezvous's lower rungs the pingpong job measures
# after its default run (CMA where the node agrees it): the arena with the
# pipelined rendezvous, then the file (pingpong.py --rungs)
MPIRUN_RUNGS = ("arena", "file")


def _mpirun_job(args, tag, env=None, expect=None):
    """Run ``python -m mvapich2_tpu_torch.run <args>`` from the checkout,
    with ``env`` added to the environment; returns (the parsed ``<tag>
    {...}`` line, seconds). ``expect``: a line the job must print."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mvapich2_tpu_torch.run",
                           *args], cwd=HERE, capture_output=True, text=True,
                          timeout=MPIRUN_TIMEOUT,
                          env={**os.environ, **(env or {})})
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[mpirun] {' '.join(args)} exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(tag + " ")]
    if len(lines) != 1 or (expect is not None
                           and expect not in proc.stdout.splitlines()):
        raise AssertionError(f"[mpirun] {' '.join(args)} printed "
                             f"{len(lines)} {tag} lines:\n{proc.stdout}")
    return json.loads(lines[0].split(" ", 1)[1]), wall


def phase_mpirun(torch, smi, mesh_lat):
    """The MPI program entry (module docstring, phase 17). Returns its
    figures."""
    t_phase = time.perf_counter()
    vp, vp_wall = _mpirun_job(["-np", str(R), "--vpod", sys.executable,
                               VPOD_PROG], "VPOD_JSON")
    calls, got = vp["calls"], vp["launches"]
    want = {"hbm_ring_all_reduce": calls["allreduce_big"],
            "ring_all_reduce": calls["allreduce_small"],
            "hbm_ring_all_gather": 1, "ring_all_gather": 1,
            "hbm_alltoall": 1, "hbm_alltoallv": 1,
            "hbm_ring_reduce_scatter": 0, "remote_sendrecv": 0,
            "quant_ring_all_reduce": 0}
    if vp["counts_of"] != "LAUNCHES" or got != want or not vp["bitwise"] \
            or vp["ranks"] != R or not vp["device"].startswith("cuda"):
        raise AssertionError(f"[mpirun] --vpod on {vp['device']}: launches "
                             f"{got} ({vp['counts_of']}), expected {want}")
    mesh_med = [statistics.median(x) for x in mesh_lat]
    big, small = calls["median_big_s"], calls["median_small_s"]
    log(f"[mpirun] mpirun -np {R} --vpod: allreduce 64 MiB f32 median "
        f"{big * 1e3:.3f} ms ([mesh] run_ranks {mesh_med[0] * 1e3:.3f} "
        f"ms), 4 KiB {small * 1e6:.1f} us ([mesh] "
        f"{mesh_med[1] * 1e6:.1f} us); every result "
        f"bitwise stock torch; launches {got}; job {vp_wall:.1f} s on {smi}")
    pp, pp_wall = _mpirun_job(["-np", "4", "--fake-nodes", "0,0,1,1",
                               sys.executable, PINGPONG_PROG, "--rungs",
                               ",".join(MPIRUN_RUNGS)], "PINGPONG_JSON")
    if pp.get("card_tensor_refused") != "cuda" or \
            set(pp["pingpong_us"]) != {"shm", "tcp"}:
        raise AssertionError(f"[mpirun] process mode: {pp}")
    fmt = lambda d: ", ".join(f"{k} B {v:.1f}" for k, v in d.items())
    log(f"[mpirun] mpirun -np 4 --fake-nodes 0,0,1,1: half round trip (us) "
        f"over shm {fmt(pp['pingpong_us']['shm'])}; over tcp "
        f"{fmt(pp['pingpong_us']['tcp'])}; allreduce 8 B "
        f"{pp['allreduce_8B_us']:.1f} us, barrier {pp['barrier_us']:.1f} "
        f"us; mpi.Init {max(pp['init_s']):.3f} s (slowest rank); a tensor "
        f"on the card refused with NotImplementedError; job {pp_wall:.1f} "
        f"s on {smi}")
    rungs = {"default": pp, **pp["rung_runs"]}
    if list(pp["rung_runs"]) != list(MPIRUN_RUNGS):
        raise AssertionError(f"[mpirun] rung runs {list(pp['rung_runs'])}")
    for rung, res in rungs.items():
        pv, agreed = res["pvars_rank0"], res["rungs"]
        took = ("cma" if pv["rndv_cma_bytes"] else
                "arena" if pv["arena_allocs"] else "file")
        want = {"arena": "arena", "file": "file"}.get(
            rung, "cma" if agreed["cma"] else "arena")
        if took != want or (rung == "arena" and (
                agreed != {"cma": False, "arena": True}
                or not pv["rndv_pipeline_chunks"])) or (
                rung == "file" and (pv["rndv_pipeline_chunks"]
                                    or agreed["arena"])):
            raise AssertionError(f"[mpirun] the {rung} rung took {took} "
                                 f"(agreed {agreed}, pvars {pv})")
        res["rung_taken"] = took
        log(f"[mpirun] shm rendezvous, {rung}: agreed {agreed}, took "
            f"{took}; half round trip (us) over shm "
            f"{fmt(res['pingpong_us']['shm'])} (tcp in the same job "
            f"{fmt(pp['pingpong_us']['tcp'])}); rank 0 counters "
            f"rndv_cma_bytes {pv['rndv_cma_bytes']:.0f}, "
            f"rndv_pipeline_chunks {pv['rndv_pipeline_chunks']:.0f}, "
            f"arena_allocs {pv['arena_allocs']:.0f} on {smi}")
    total = time.perf_counter() - t_phase
    log(f"[mpirun] phase {total:.1f} s")
    return {"vpod": vp, "vpod_job_s": vp_wall,
            "mesh_run_ranks_median_s": mesh_med, "process": pp,
            "process_job_s": pp_wall, "rungs": rungs, "phase_s": total}


CARD_SMALL = 8 * 1024              # bf16 elements: 16 KiB a rank
CARD_BIG = 32 * 1024 * 1024        # bf16 elements: 64 MiB a rank
CARD_AG = (1024, 512 * 1024)       # bf16 allgather a rank: 2 KiB (K7), 1 MiB (K5)
CARD_TIMED = 5                     # calls timed a way (host clock, card), after one
CARD_SLEEP = 100_000_000           # sleep-kernel cycles (~50 ms) before a card-timed call
CARD_WIN = 16 * 1024 * 1024        # f32 elements a row of the (2, 4) windows: 64 MiB
CARD_WIN_OP = 4 * 1024 * 1024      # f32 elements a window op: 16 MiB
_LEADER = threading.local()


def _no_bf16_stock(torch, ici, a2a):
    """Make a bfloat16 tensor that reaches the stock tier raise: the tier
    picks (``planned_tier``, ``planned_a2a_tier``) answering 'xla' for
    it, and the stock reduction given it. Returns the function that
    restores them."""
    saved = []

    def pick(real, name):
        def guard(*a, **kw):
            tier = real(*a, **kw)
            if tier[0] == "xla" and torch.bfloat16 in a:
                raise AssertionError(f"[card_paths] {name} sent a bfloat16 "
                                     f"call to the stock tier: {tier}")
            return tier
        return guard

    def reduction(real):
        def guard(x, op):
            if x.dtype == torch.bfloat16:
                raise AssertionError("[card_paths] a bfloat16 tensor "
                                     "reached the stock reduction")
            return real(x, op)
        return guard
    for mod, name, wrap in ((ici, "planned_tier", pick),
                            (a2a, "planned_a2a_tier", pick),
                            (ici, "stock_reduce", None)):
        real = getattr(mod, name)
        setattr(mod, name, wrap(real, name) if wrap else reduction(real))
        saved.append((mod, name, real))

    def restore():
        for mod, name, real in saved:
            setattr(mod, name, real)
    return restore


def _card_path(torch, mvt, mods, what, kw, call, want, check, timed,
               nranks=R, tag="card_paths"):
    """One call of one path on ``nranks`` ranks (``run_ranks(nranks, ...,
    **kw)``):
    ``call(comm)`` once, its result held by ``check(rank, out)``; with
    ``timed``, CARD_TIMED more calls each ended by a stream synchronize
    (rank 0's host clock) and CARD_TIMED queued on rank 0's stream behind
    a sleep kernel, bracketed by CUDA events (the card's time: the
    leader, rank 0, skips its host-side ``ring.check_errors`` wait for
    these, so nothing in the call waits for the card). The kernel counts
    are zeroed just before the run and read just after it; they must be
    ``want`` a call (``want`` None: any). Returns (launches, host ms
    median, card ms median, whether every card-timed call was still
    queued when it returned)."""
    def app(comm):
        r = comm.rank
        stream = torch.cuda.current_stream()
        check(r, call(comm))
        stream.synchronize()
        host, card, queued = [], [], True
        for _ in range(CARD_TIMED if timed else 0):
            t0 = time.perf_counter()
            call(comm)
            stream.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        for _ in range(CARD_TIMED if timed else 0):
            if r == 0:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(CARD_SLEEP)
                start.record()
                _LEADER.skip_wait = True
            try:
                call(comm)
            finally:
                _LEADER.skip_wait = False
            if r == 0:
                end.record()
                queued = queued and not start.query()
                end.synchronize()
                card.append(start.elapsed_time(end))
        stream.synchronize()
        return host, card, queued

    ncalls = 1 + (2 * CARD_TIMED if timed else 0)
    _zero(*mods)
    res = mvt.run_ranks(nranks, app, **kw)
    torch.cuda.synchronize()
    got = {k: v for k, v in _launches(*mods).items() if v}
    exp = got if want is None else {k: v * ncalls for k, v in want.items()}
    if got != exp:
        raise AssertionError(f"[{tag}] {what}: launches {got}, "
                             f"expected {exp} ({ncalls} calls)")
    host, card, queued = res[0]
    med = (lambda x: statistics.median(x) if x else None)
    return got, med(host), med(card), queued


def _exact(torch, what, got, want):
    """Bitwise equality of two tensors on the card (bf16 as its bits)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"[card_paths] {what}: {got.dtype} "
                             f"{tuple(got.shape)}, expected {want.dtype} "
                             f"{tuple(want.shape)}")
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    if not torch.equal(got, want):
        raise AssertionError(f"[card_paths] {what}: not bitwise the plain "
                             f"result")


def phase_card_paths(torch, np, mvt, hbm, ici, ring, a2a, rma, mpit, moe,
                     MeshComm, make_mesh, timing, info, smi, dev):
    """The device paths for tensors that the JAX package stages through
    its host tier, and the window over one axis of a multi-axis mesh
    (module docstring, phase 18). Returns its figures."""
    from mvapich2_tpu_torch.coll import device as coll_dev
    from mvapich2_tpu_torch.core import comm as comm_mod
    from mvapich2_tpu_torch.core import op as opmod
    from mvapich2_tpu_torch.rma import DeviceWin
    t_phase = time.perf_counter()
    mods = (hbm, ici, ring, a2a, rma)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2600)

    def ints(n, dtype=torch.bfloat16):
        return torch.randint(-8, 8, (n,), generator=gen, device=dev,
                             dtype=torch.int32).to(dtype)
    small = [ints(CARD_SMALL) for _ in range(R)]
    big = [ints(CARD_BIG) for _ in range(R)]
    ag = [[ints(n) for _ in range(R)] for n in CARD_AG]
    blocks = [ints(N) for _ in range(R)]          # 32 MiB bf16 a rank
    counts = _moe_counts(moe, "hot")
    vs = [torch.randn(sum(counts[r]), generator=gen, device=dev)
          for r in range(R)]
    sum_small = torch.stack(small).float().sum(0).to(torch.bfloat16)
    sum_big = torch.stack(big).float().sum(0).to(torch.bfloat16)
    max_big = torch.stack(big).amax(0)
    cat_ag = [torch.cat(a) for a in ag]
    c = N // R
    a2a_want = torch.stack(blocks).reshape(R, R, c).transpose(0, 1) \
        .reshape(R, N).clone()
    sd = [np.cumsum([0] + row[:-1]).tolist() for row in counts]
    v_want = [torch.cat([vs[j][sd[j][r]:sd[j][r] + counts[j][r]]
                         for j in range(R)]) for r in range(R)]
    rsb_want = sum_big.reshape(R, CARD_BIG // R)

    def allreduce(xs, op=None):
        return lambda comm: comm.allreduce(xs[comm.rank], op=op)

    def alltoallv(comm):
        r = comm.rank
        rc = [counts[j][r] for j in range(R)]
        return comm.alltoallv(vs[r], counts[r], None, None, rc, None)

    def is_(want):
        return lambda r, out: _exact(torch, "result", out, want)

    slot = {"device": dev}
    mesh = {"device_mesh": make_mesh((R,), ("x",), dev)}
    fold = {"device_mesh": make_mesh((2,), ("x",), dev)}
    mesh24 = {"device_mesh": make_mesh((2, 4), ("x", "y"), dev)}
    k1, k3, k6 = ("fused_reduce_to_slot", "hbm_ring_all_reduce",
                  "ring_all_reduce")
    # (what, run_ranks arguments, call, launches a call, check, timed)
    cases = [
        ("slot bf16 allreduce 16 KiB", slot, allreduce(small), {k1: 1},
         is_(sum_small), True),
        ("slot bf16 allreduce 64 MiB", slot, allreduce(big), {k1: 1},
         is_(sum_big), True),
        ("slot alltoallv MoE hot f32", slot, alltoallv,
         {"hbm_alltoallv": 1}, lambda r, o: _exact(torch, "alltoallv", o,
                                                   v_want[r]), True),
        ("mesh bf16 allreduce 16 KiB", mesh, allreduce(small), {k6: 1},
         is_(sum_small), True),
        ("mesh bf16 allreduce 64 MiB", mesh, allreduce(big), {k3: 1},
         is_(sum_big), True),
        ("mesh bf16 max 64 MiB", mesh, allreduce(big, opmod.MAX), {k3: 1},
         is_(max_big), False),
        ("mesh bf16 reduce_scatter_block 64 MiB", mesh,
         lambda comm: comm.reduce_scatter_block(big[comm.rank]),
         {"hbm_ring_reduce_scatter": 1},
         lambda r, o: _exact(torch, "reduce_scatter_block", o,
                             rsb_want[r]), False),
        ("mesh bf16 allgather 2 KiB", mesh,
         lambda comm: comm.allgather(ag[0][comm.rank]),
         {"ring_all_gather": 1}, is_(cat_ag[0]), False),
        ("mesh bf16 allgather 1 MiB", mesh,
         lambda comm: comm.allgather(ag[1][comm.rank]),
         {"hbm_ring_all_gather": 1}, is_(cat_ag[1]), False),
        ("fold bf16 allreduce 16 KiB", fold, allreduce(small),
         {k1: 2, k6: 1}, is_(sum_small), True),
        ("fold bf16 allreduce 64 MiB", fold, allreduce(big),
         {k1: 2, k3: 1}, is_(sum_big), True),
        ("fold bf16 alltoall 32 MiB", fold,
         lambda comm: comm.alltoall(blocks[comm.rank]),
         {"hbm_alltoall": 1}, lambda r, o: _exact(torch, "alltoall", o,
                                                  a2a_want[r]), False),
        ("fold alltoallv MoE hot f32", fold, alltoallv,
         {"hbm_alltoallv": 1}, lambda r, o: _exact(torch, "alltoallv", o,
                                                   v_want[r]), True),
        ("(2, 4) bf16 allreduce 64 MiB", mesh24, allreduce(big),
         {"hbm_ring_reduce_scatter": 2, "hbm_ring_all_gather": 2},
         is_(sum_big), True),
        ("(2, 4) bf16 reduce_scatter_block 64 MiB", mesh24,
         lambda comm: comm.reduce_scatter_block(big[comm.rank]),
         {"hbm_ring_reduce_scatter": 2},
         lambda r, o: _exact(torch, "reduce_scatter_block", o,
                             rsb_want[r]), False),
    ]
    pv = ("dev_coll_fallback_dtype", "dev_coll_fallback_size")
    pv0 = {k: mpit.pvar(k).read() for k in pv}
    real_check, real_host = ring.check_errors, (coll_dev.to_host,
                                                comm_mod.to_host)

    def leader_check(device=None):
        if not getattr(_LEADER, "skip_wait", False):
            real_check(device)

    def no_copy(x):
        raise AssertionError("[card_paths] a tensor on the card was "
                             "copied to the host")
    restore = _no_bf16_stock(torch, ici, a2a)
    ring.check_errors = leader_check
    coll_dev.to_host = comm_mod.to_host = no_copy
    rows = []
    try:
        for what, kw, call, want, check, timed in cases:
            got, host_ms, card_ms, queued = _card_path(
                torch, mvt, mods, what, kw, call, want, check, timed)
            rows.append({"path": what, "launches": got, "host_ms": host_ms,
                         "card_ms": card_ms, "card_queued": queued})
            log(f"[card_paths] {what}: every rank bitwise the plain "
                f"result; launches {got}" + (
                    f"; host clock {host_ms:.4f} ms, card {card_ms:.4f} ms"
                    f"{'' if queued else ' (not queued: host time in it)'}"
                    f" (median of {CARD_TIMED}) on {smi}" if timed else ""))
    finally:
        restore()
        ring.check_errors = real_check
        coll_dev.to_host, comm_mod.to_host = real_host
    ring.check_errors()
    moved = {k: mpit.pvar(k).read() - pv0[k] for k in pv}
    if any(moved.values()):
        raise AssertionError(f"[card_paths] fallback pvars moved: {moved}")
    out = {"paths": rows, "windows": [], "kernels": {}}
    # a DeviceWin over each axis of the (2, 4) mesh
    m24 = make_mesh((2, 4), ("x", "y"), dev)
    src = ints(CARD_WIN_OP, torch.float32)
    for axis in ("x", "y"):
        win = DeviceWin(MeshComm(m24, axis), CARD_WIN)
        p = win.p
        init = ints(p * CARD_WIN, torch.float32).reshape(p, CARD_WIN)
        for r in range(p):
            win.store(r, 0, init[r])
        plain = init.clone()
        _zero(*mods)
        win.put(src, 0, p - 1, 5)
        h = win.get(CARD_WIN_OP, p - 1, 0, 7)
        win.accumulate(src, p - 1, 1, 3)
        win.fence()
        rma.direct_put(src, win.win, 1, 0, CARD_WIN - CARD_WIN_OP)
        torch.cuda.synchronize()
        got = {k: v for k, v in _launches(*mods).items() if v}
        exp = {"rma_put": 1, "rma_get": 1, "rma_accumulate": 1,
               "direct_put": 1}
        if got != exp:
            raise AssertionError(f"[card_paths] window over {axis}: "
                                 f"launches {got}, expected {exp}")
        plain[p - 1, 5:5 + CARD_WIN_OP] = src
        got_want = plain[0, 7:7 + CARD_WIN_OP].clone()
        plain[1, 3:3 + CARD_WIN_OP] += src
        plain[0, CARD_WIN - CARD_WIN_OP:] = src
        _exact(torch, f"window over {axis}", win.win, plain)
        _exact(torch, f"window get over {axis}", h.value(), got_want)
        ops = {"put": lambda: rma.rma_put(src, win.win, 0, p - 1, 5),
               "get": lambda: rma.rma_get(win.win, CARD_WIN_OP, p - 1, 0,
                                          7),
               "acc": lambda: rma.rma_accumulate(src, win.win, p - 1, 1,
                                                 3),
               "direct_put": lambda: rma.direct_put(src, win.win, 1, 0,
                                                    5)}
        card = {k: _queued_ms(torch, f) for k, f in ops.items()}
        host = {}
        for k in ("put", "get", "acc"):
            samples = []
            for _ in range(CARD_TIMED):
                t0 = time.perf_counter()
                if k == "put":
                    win.put(src, 0, p - 1, 5)
                elif k == "get":
                    win.get(CARD_WIN_OP, p - 1, 0, 7)
                else:
                    win.accumulate(src, p - 1, 1, 3)
                win.fence()
                samples.append((time.perf_counter() - t0) * 1e3)
            host[k] = statistics.median(samples)
        nb = CARD_WIN_OP * 4
        bound = {k: (3 if k == "acc" else 2) * nb / (
            info.hbm_bw_gbps * 1e9) * 1e3 for k in ops}
        out["windows"].append({"axis": axis, "p": p, "launches": got,
                               "card_ms": card, "host_fence_ms": host,
                               "bound_ms": bound})
        log(f"[card_paths] DeviceWin over {axis} of (2, 4) (p = {p}, "
            f"64 MiB f32 a row): put/get/accumulate/direct_put of 16 MiB "
            f"bitwise the plain replay; launches {got}; card ms "
            + ", ".join(f"{k} {v:.4f} (bound {bound[k]:.4f})"
                        for k, v in card.items())
            + "; op + fence on the host clock ms "
            + ", ".join(f"{k} {v:.4f}" for k, v in host.items())
            + f" (median of {CARD_TIMED}) on {smi}")
    # K1 and K3 at 8 x 64 MiB: bf16 beside f32, the same bytes
    f32 = [torch.randn(CARD_BIG // 2, generator=gen, device=dev)
           for _ in range(R)]
    kern = {}
    shard = big[0].numel() * 2                 # bytes a rank, both dtypes
    for name, fn, rows in (
            ("K1 bf16", lambda: hbm.hbm_slot_allreduce(big), R + 1),
            ("K1 f32", lambda: hbm.hbm_slot_allreduce(f32), R + 1),
            ("K3 bf16", lambda: ici.hbm_ring_all_reduce(big), 2 * R),
            ("K3 f32", lambda: ici.hbm_ring_all_reduce(f32), 2 * R)):
        ms = timing.time_ms(fn)
        # K1 reads R rows and writes one; K3 reads R rows and writes R
        bound = rows * shard / (info.hbm_bw_gbps * 1e9) * 1e3
        kern[name] = {"ms": ms, "bound_ms": bound}
    ring.check_errors()
    out["kernels"] = kern
    log("[card_paths] at 8 x 64 MiB a rank: " + "; ".join(
        f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f})"
        for k, v in kern.items()) + f" on {smi}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[card_paths] phase {out['phase_s']:.1f} s; no bfloat16 tensor "
        f"reached a stock lowering, dev_coll_fallback_* unmoved, no tensor "
        f"copied to the host")
    return out


DERIVED_SMALL = 4 * 1024           # f32 elements: 16 KiB a rank
DERIVED_BIG = 16 * 1024 * 1024     # f32 elements: 64 MiB a rank
DERIVED_AG = 512 * 1024            # f32 elements: 2 MiB a rank
DERIVED_V = 1024                   # f32 elements: the alltoallv's unit
DERIVED_TOL = 0.05                 # the prediction: derived card time


def _derived_counts(k):
    """The alltoallv count matrix of a comm of ``k`` ranks: rank j sends
    ``counts[j][i]`` f32 to rank i (1 to 3 units, seeded by position)."""
    return [[DERIVED_V * ((i + 2 * j) % 3 + 1) for i in range(k)]
            for j in range(k)]


def phase_derived(torch, np, mvt, hbm, ici, ring, a2a, mpit, make_mesh,
                  smi, dev):
    """Comms made by split and dup, and the slot and fold channels'
    nonblocking calls, on the card (module docstring, phase 19). Returns
    its figures."""
    from mvapich2_tpu_torch.coll import device as coll_dev
    from mvapich2_tpu_torch.core import comm as comm_mod
    t_phase = time.perf_counter()
    mods = (hbm, ici, ring, a2a)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2800)

    def ints(n):
        return torch.randint(-8, 8, (n,), generator=gen, device=dev,
                             dtype=torch.int32).float()
    k1, k3, k6 = ("fused_reduce_to_slot", "hbm_ring_all_reduce",
                  "ring_all_reduce")
    slot = {"device": dev}
    mesh4 = {"device_mesh": make_mesh((4,), ("x",), dev)}
    fold = {"device_mesh": make_mesh((2,), ("x",), dev)}
    # (geometry, run_ranks arguments, how each rank derives its comm, the
    # groups in comm rank order, the COMM_WORLD of the same k and
    # geometry, the allreduce kernels of one comm: 16 KiB, 64 MiB)
    geoms = [
        ("slot split(rank // 4)", slot, lambda c: c.split(c.rank // 4),
         [[0, 1, 2, 3], [4, 5, 6, 7]], slot, {k1: 1}, {k1: 1}),
        ("mesh split(rank % 2)", {"device_mesh": make_mesh((R,), ("x",),
                                                           dev)},
         lambda c: c.split(c.rank % 2), [[0, 2, 4, 6], [1, 3, 5, 7]],
         mesh4, {k6: 1}, {k3: 1}),
        ("(2, 4) split(rank // 4)",
         {"device_mesh": make_mesh((2, 4), ("x", "y"), dev)},
         lambda c: c.split(c.rank // 4), [[0, 1, 2, 3], [4, 5, 6, 7]],
         mesh4, {k6: 1}, {k3: 1}),
        ("fold dup", fold, lambda c: c.dup(), [list(range(R))], fold,
         {k1: 2, k6: 1}, {k1: 2, k3: 1}),
    ]
    data = {"small": [ints(DERIVED_SMALL) for _ in range(R)],
            "big": [ints(DERIVED_BIG) for _ in range(R)],
            "ag": [ints(DERIVED_AG) for _ in range(R)]}

    def run_path(kw, nranks, derive, groups, call, want, label):
        """``call(comm, world rank, group)`` on each rank's derived comm
        (or, with ``derive`` None, on COMM_WORLD, standing for group 0's
        ranks); the first call's result held bitwise against the plain
        one (``call``'s second value), the others timed."""
        cache = {}

        def where(r):
            if derive is None:
                return groups[0][r], groups[0]
            return r, next(g for g in groups if r in g)

        def on(comm):
            c = comm
            if derive is not None:
                got = cache.get(comm.rank)
                if got is None or got[0] is not comm:
                    got = cache[comm.rank] = (comm, derive(comm))
                c = got[1]
            return call(c, *where(comm.rank))[0]

        def check(r, out):
            _exact(torch, label, out, call(None, *where(r))[1])
        return _card_path(torch, mvt, mods, label, kw, on, want, check,
                          True, nranks, "derived")

    # each call: (the result on comm c, or None; the plain result)
    def allreduce(key):
        def call(c, w, g):
            return (c.allreduce(data[key][w]) if c is not None else None,
                    sum(data[key][m] for m in g) if c is None else None)
        return call

    def allgather(c, w, g):
        if c is not None:
            return c.allgather(data["ag"][w]), None
        return None, torch.cat([data["ag"][m] for m in g])

    def vrow(w, k, i, lo, n):
        """Elements ``lo:lo + n`` of world rank ``w``'s alltoallv send
        buffer (local rank ``i`` of a comm of ``k``): a seeded ramp."""
        return torch.arange(lo, lo + n, device=dev,
                            dtype=torch.float32) + 1e5 * w

    def alltoallv(c, w, g):
        k, i = len(g), g.index(w)
        cnt = _derived_counts(k)
        if c is not None:
            return c.alltoallv(vrow(w, k, i, 0, sum(cnt[i])), cnt[i], None,
                               None, [cnt[j][i] for j in range(k)],
                               None), None
        sd = [np.cumsum([0] + row[:-1]).tolist() for row in cnt]
        return None, torch.cat([vrow(g[j], k, j, sd[j][i], cnt[j][i])
                                for j in range(k)])

    real_check, real_host = ring.check_errors, (coll_dev.to_host,
                                                comm_mod.to_host)

    def leader_check(device=None):
        if not getattr(_LEADER, "skip_wait", False):
            real_check(device)

    def no_copy(x):
        raise AssertionError("[derived] a tensor on the card was copied "
                             "to the host")
    ring.check_errors = leader_check
    coll_dev.to_host = comm_mod.to_host = no_copy
    ncalls = 1 + 2 * CARD_TIMED
    rows, nb = [], {}
    try:
        for geom, kw, derive, groups, ref_kw, ar_small, ar_big in geoms:
            k, ncomm = len(groups[0]), len(groups)
            for what, call, want in (
                    ("allreduce 16 KiB", allreduce("small"), ar_small),
                    ("allreduce 64 MiB", allreduce("big"), ar_big),
                    ("allgather 2 MiB", allgather, None),
                    ("alltoallv", alltoallv, {"hbm_alltoallv": 1})):
                ref = run_path(ref_kw, k, None, groups, call, want,
                               f"COMM_WORLD of {k} {what}")
                per = {n: v // ncalls for n, v in ref[0].items()}
                if not per and not geom.startswith("slot"):
                    raise AssertionError(f"[derived] {geom} {what}: the "
                                         f"COMM_WORLD call launched nothing")
                der = run_path(kw, R, derive, groups, call,
                               {n: v * ncomm for n, v in per.items()},
                               f"{geom} {what}")
                row = {"geometry": geom, "call": what, "k": k,
                       "comms": ncomm, "launches_a_comm": per,
                       "host_ms": der[1], "card_ms": der[2],
                       "card_queued": der[3], "world_host_ms": ref[1],
                       "world_card_ms": ref[2]}
                if what == "allreduce 64 MiB":
                    row["within_5pct"] = abs(der[2] - ref[2]) <= \
                        DERIVED_TOL * ref[2]
                rows.append(row)
                log(f"[derived] {geom} ({ncomm} comm(s) of {k}) {what}: "
                    f"every rank bitwise the plain result; launches "
                    f"{per} a comm; card {der[2]:.4f} ms (COMM_WORLD of "
                    f"{k}: {ref[2]:.4f}), host {der[1]:.4f} ms "
                    f"({ref[1]:.4f}) (median of {CARD_TIMED}) on {smi}")
        nb = _derived_nbc(torch, np, mvt, hbm, ici, ring, a2a, mpit, ints,
                          slot, fold, smi, dev)
    finally:
        ring.check_errors = real_check
        coll_dev.to_host, comm_mod.to_host = real_host
    ring.check_errors()
    out = {"paths": rows, "nbc": nb,
           "phase_s": time.perf_counter() - t_phase}
    log(f"[derived] phase {out['phase_s']:.1f} s; no tensor copied to the "
        f"host")
    return out


DERIVED_NB_RUNS = 5                # i-call + wait timed, after 1
DERIVED_SWITCH = 5e-4              # s: the i-calls timed again under this
                                   # GIL switch interval (Python's is 5 ms)


def _derived_nbc(torch, np, mvt, hbm, ici, ring, a2a, mpit, ints, slot,
                 fold, smi, dev):
    """iallreduce of 64 MiB, ialltoallv and allreduce_init (3 starts of
    16 KiB) into tensors on the slot channel and the fold channel (8 ranks
    over 2 devices): each request on the device NBC tier, each result
    bitwise the plain one, the launches a path counted (zeroed just
    before, read just after); then iallreduce + wait beside the blocking
    allreduce of the same 64 MiB on the host clock, with the i-call's
    host split (``_derived_nb_split``)."""
    from mvapich2_tpu_torch.coll import device as coll_dev
    mods = (hbm, ici, ring, a2a)
    k1, k3, k6 = ("fused_reduce_to_slot", "hbm_ring_all_reduce",
                  "ring_all_reduce")
    big = [ints(DERIVED_BIG) for _ in range(R)]
    small = [ints(DERIVED_SMALL) for _ in range(R)]
    cnt = _derived_counts(R)
    sd = [np.cumsum([0] + row[:-1]).tolist() for row in cnt]
    vs = [torch.arange(sum(cnt[r]), device=dev, dtype=torch.float32)
          + 1e5 * r for r in range(R)]
    v_want = [torch.cat([vs[j][sd[j][r]:sd[j][r] + cnt[j][r]]
                         for j in range(R)]) for r in range(R)]
    sum_big, sum_small = sum(big), sum(small)
    nseg = 8      # DEVICE_NBC_SEG_BYTES 1 MiB, DEVICE_NBC_MAX_SEGS 8
    out = {}
    for name, kw, want in (
            ("slot", slot, {"iallreduce": {k1: nseg},
                            "ialltoallv": {"hbm_alltoallv": 1},
                            "allreduce_init": {k1: 3}}),
            ("fold", fold, {"iallreduce": {k1: 2 * nseg, k3: nseg},
                            "ialltoallv": {"hbm_alltoallv": 1},
                            "allreduce_init": {k1: 6, k6: 3}})):
        got = {}
        for call in ("iallreduce", "ialltoallv", "allreduce_init"):
            def app(comm, call=call):
                r = comm.rank
                if call == "iallreduce":
                    recv = torch.empty_like(big[r])
                    req = comm.iallreduce(big[r], recv)
                    req.wait()
                    _exact(torch, "iallreduce", recv, sum_big)
                    return req.device_nbc
                if call == "ialltoallv":
                    recv = torch.empty_like(v_want[r])
                    req = comm.ialltoallv(vs[r], cnt[r], None, recv,
                                          [cnt[j][r] for j in range(R)],
                                          None)
                    req.wait()
                    _exact(torch, "ialltoallv", recv, v_want[r])
                    return req.device_nbc
                recv = torch.empty_like(small[r])
                req = comm.allreduce_init(small[r], recv)
                for _ in range(3):
                    recv.zero_()
                    req.start()
                    req.wait()
                    _exact(torch, "allreduce_init", recv, sum_small)
                req.free()
                return True
            fb = mpit.pvar("dev_coll_fallback_nbc").read()
            starts = mpit.pvar("dev_persistent_starts").read()
            _zero(*mods)
            res = mvt.run_ranks(R, app, **kw)
            torch.cuda.synchronize()
            got[call] = {k: v for k, v in _launches(*mods).items() if v}
            if res != [True] * R or got[call] != want[call]:
                raise AssertionError(
                    f"[derived] {name} {call}: device_nbc {res}, launches "
                    f"{got[call]}, expected {want[call]}")
            if mpit.pvar("dev_coll_fallback_nbc").read() != fb:
                raise AssertionError(f"[derived] {name} {call}: counted "
                                     f"dev_coll_fallback_nbc")
            if call == "allreduce_init" and \
                    mpit.pvar("dev_persistent_starts").read() - starts \
                    != 3 * R:
                raise AssertionError(f"[derived] {name}: persistent "
                                     f"starts not on the device tier")

        def timed(comm):
            r = comm.rank
            stream = torch.cuda.current_stream()
            recv = torch.empty_like(big[r])
            lat = {"iallreduce_wait": [], "allreduce": []}
            stamps = []          # (start, posted, waited) of each i-call
            for i in range(DERIVED_NB_RUNS + 1):
                t0 = time.perf_counter()
                req = comm.iallreduce(big[r], recv)
                tp = time.perf_counter()
                req.wait()
                stream.synchronize()
                t1 = time.perf_counter()
                stamps.append((t0, tp, t1))
                comm.allreduce(big[r])
                stream.synchronize()
                if i:
                    lat["iallreduce_wait"].append((t1 - t0) * 1e3)
                    lat["allreduce"].append(
                        (time.perf_counter() - t1) * 1e3)
            return {k: statistics.median(v) for k, v in lat.items()}, stamps
        out[name] = {"launches": got}
        real_switch = sys.getswitchinterval()
        for switch in (real_switch, DERIVED_SWITCH):
            marks, restore = _nb_host_timers(coll_dev)
            real_land = coll_dev._land
            coll_dev._land = _timed_mark(marks, "land", real_land)
            sys.setswitchinterval(switch)
            try:
                res = mvt.run_ranks(R, timed, **kw)
            finally:
                sys.setswitchinterval(real_switch)
                coll_dev._land = real_land
                restore()
            host = res[0][0]
            split = _derived_nb_split(marks, [st for _, st in res], nseg)
            key = "" if switch == real_switch else "_short_switch"
            out[name].update({"host_ms" + key: host,
                              "host_split" + key: split})
            log(f"[derived] {name} channel: iallreduce 64 MiB, ialltoallv "
                f"and allreduce_init x 3 into tensors on the device NBC "
                f"tier, bitwise the plain results; launches {got}; "
                f"iallreduce + wait {host['iallreduce_wait']:.4f} ms, "
                f"allreduce {host['allreduce']:.4f} ms on the host clock "
                f"(median of {DERIVED_NB_RUNS}; GIL switch interval "
                f"{switch * 1e3:g} ms) on {smi}")
            log(f"[derived] {name} channel: host split of the 64 MiB "
                f"iallreduce + wait, ms (median of {DERIVED_NB_RUNS}; GIL "
                f"switch interval {switch * 1e3:g} ms): " + ", ".join(
                    f"{k} {v:.4f}" for k, v in split.items()))
    return out



def _derived_nb_split(marks, stamps, nseg):
    """Where one iallreduce + wait's host time goes, from the
    ``_nb_host_timers`` marks and each rank's (start, posted, waited)
    stamps, medians over the timed calls (the first is a warm-up): the
    first rank's start to the first segment launch (the posts and the
    deposits' arrival), the launches (the first also stages the
    deposits), the last launch to the last rank's finish (the card's run
    seen through the polls), and that finish to the last rank's return
    from wait plus a synchronize; a rank's finish and the landing copy
    inside it (``_land``); with the launches' and polls' own host time a
    call. Every segment is launched in a call
    before the next call starts: the blocking allreduce between them
    meets every rank."""
    launch = sorted((a, b) for _, k, a, b in marks if k == "launch")
    finish = sorted((a, b) for _, k, a, b in marks if k == "finish")
    lands = sorted((a, b) for _, k, a, b in marks if k == "land")
    polls = [b - a for _, k, a, b in marks if k == "poll"]
    n_calls = len(stamps[0])
    if len(launch) != nseg * n_calls or \
            len(finish) != R * n_calls or len(lands) != R * n_calls:
        raise AssertionError(f"[derived] {len(launch)} segment launches "
                             f"and {len(finish)} finishes in {n_calls} "
                             f"calls of {R} ranks")
    parts = collections.defaultdict(list)
    for i in range(1, n_calls):
        start = min(st[i][0] for st in stamps)
        end = max(st[i][2] for st in stamps)
        ls = launch[i * nseg:(i + 1) * nseg]
        fs = finish[i * R:(i + 1) * R]
        parts["post_ms"].append(statistics.median(
            st[i][1] - st[i][0] for st in stamps) * 1e3)
        parts["to_first_launch_ms"].append((ls[0][0] - start) * 1e3)
        parts["launches_ms"].append((ls[-1][1] - ls[0][0]) * 1e3)
        parts["first_launch_ms"].append((ls[0][1] - ls[0][0]) * 1e3)
        parts["last_launch_to_last_finish_ms"].append(
            (max(b for _, b in fs) - ls[-1][1]) * 1e3)
        parts["last_finish_to_return_ms"].append(
            (end - max(b for _, b in fs)) * 1e3)
        parts["finish_ms"].append(statistics.median(
            b - a for a, b in fs) * 1e3)
        parts["land_ms"].append(statistics.median(
            b - a for a, b in lands[i * R:(i + 1) * R]) * 1e3)
        parts["total_ms"].append((end - start) * 1e3)
    split = {k: statistics.median(v) for k, v in parts.items()}
    split["polls_a_call"] = len(polls) / n_calls
    split["poll_ms_a_call"] = (sum(polls) - sum(b - a for a, b in launch)) \
        / n_calls * 1e3
    return split


SPAWN_PARENTS = 4                  # thread ranks on cuda:0 that spawn
SPAWN_CHILDREN = 4                 # rank threads they spawn (8 in all)
SPAWN_SIZES = (1, 16 * 1024, 1024 * 1024)   # f32 a rank: 4 B, 64 KiB, 4 MiB
SPAWN_ITERS = 5                    # timed calls a size, after one checked
SPAWN_PROG = os.path.join("mvapich2_tpu_torch", "progs", "spawn_parent.py")
SPAWN_OPS = ("allreduce", "bcast", "allgather", "alltoall",
             "reduce_scatter_block", "iallreduce", "ibcast", "iallgather",
             "ialltoall")


def _spawn_vals(np, w, tag, n):
    """World rank ``w``'s seeded integer-valued f32 buffer of ``n``
    elements for call ``tag`` (sums of eight are exact)."""
    rng = np.random.default_rng(SEED + 2900 + 16 * w + tag)
    return rng.integers(-8, 8, n).astype(np.float32)


def _spawn_calls(np, inter, pstat, me, remote):
    """Every SPAWN_OPS call at every SPAWN_SIZES size on ``inter`` (both
    sides run this in the same order): the first call of each held
    bitwise against numpy, then SPAWN_ITERS timed on the host clock.
    ``me`` is this rank's world id, ``remote`` the remote group's world
    ids in rank order. Returns {op: {bytes: median ms}}."""
    rank, size, rs = inter.rank, inter.size, inter.remote_size
    parents = remote[0] != 0         # the parents' remote group: children
    times = {}
    for tag, op in enumerate(SPAWN_OPS):
        base = op[1:] if op.startswith("i") else op
        times[op] = {}
        for n in SPAWN_SIZES:
            root = ((pstat.ROOT if rank == 0 else pstat.PROC_NULL)
                    if parents else 0)
            if base == "allreduce":
                x, out = _spawn_vals(np, me, tag, n), np.empty(n, np.float32)
                want = sum(_spawn_vals(np, q, tag, n) for q in remote)
            elif base == "bcast":
                x = _spawn_vals(np, 0, tag, n) if (parents and rank == 0) \
                    else np.zeros(n, np.float32)
                out = x
                want = None if parents else _spawn_vals(np, 0, tag, n)
            elif base == "allgather":
                x, out = _spawn_vals(np, me, tag, n), \
                    np.empty(n * rs, np.float32)
                want = np.concatenate([_spawn_vals(np, q, tag, n)
                                       for q in remote])
            elif base == "alltoall":
                x, out = _spawn_vals(np, me, tag, n * rs), \
                    np.empty(n * rs, np.float32)
                want = np.concatenate([
                    _spawn_vals(np, q, tag, n * size)[rank * n:
                                                      (rank + 1) * n]
                    for q in remote])
            else:                    # reduce_scatter_block
                x, out = _spawn_vals(np, me, tag, n * rs), \
                    np.empty(n, np.float32)
                want = sum(_spawn_vals(np, q, tag, n * size)[
                    rank * n:(rank + 1) * n] for q in remote)

            def call():
                f = getattr(inter, op)
                if base == "allreduce":
                    req = f(x, out)
                elif base == "bcast":
                    req = f(x, root=root)
                else:
                    req = f(x, out, count=n)
                if op.startswith("i"):
                    req.wait()

            call()
            if want is not None and out.tobytes() != want.tobytes():
                raise AssertionError(f"[spawn] intercomm {op} of {n} f32 "
                                     f"on world rank {me}: not bitwise "
                                     f"numpy's result")
            lat = []
            for _ in range(SPAWN_ITERS):
                t0 = time.perf_counter()
                call()
                lat.append((time.perf_counter() - t0) * 1e3)
            times[op][4 * n] = statistics.median(lat)
    return times


def _spawn_split(np, inter, me):
    """The parts of one 4 MiB intercomm allreduce (``coll/inter.py``
    ``allreduce``), each run SPAWN_ITERS times on its own on both sides:
    the local reduce to local rank 0, the leaders' exchange over the
    intercomm, the local bcast. Returns {part: median ms} on this
    rank's clock (every rank takes the exchange's tag, so the
    intercomm's counters stay in step)."""
    from mvapich2_tpu_torch.coll.algorithms import csendrecv
    lc, n = inter.local_comm, SPAWN_SIZES[-1]
    x, stage = _spawn_vals(np, me, 40, n), np.empty(n, np.float32)
    parts = {"local_reduce": lambda: lc.reduce(x, root=0),
             "leader_exchange": lambda: csendrecv(
                 inter, x, 0, stage, 0, tag) if lc.rank == 0 else None,
             "local_bcast": lambda: lc.bcast(stage, root=0)}
    out = {}
    for name, fn in parts.items():
        lat = []
        for _ in range(SPAWN_ITERS):
            tag = inter.next_coll_tag()
            lc.barrier()
            t0 = time.perf_counter()
            fn()
            lat.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(lat)
    lc.barrier()
    return out


def phase_spawn(torch, np, mvt, hbm, ici, ring, a2a, smi, dev):
    """Dynamic processes and intercomms (module docstring, phase 20).
    Returns its figures. ``main``'s forced REDUCE_ALGO=device is lifted
    meanwhile: the phase's reduces run on comms with no device channel
    (the intercomms' and the children's), whose host table has no such
    algorithm."""
    from mvapich2_tpu_torch.utils.config import get_config
    cfg = get_config()
    saved = cfg.get("REDUCE_ALGO")
    cfg.set("REDUCE_ALGO", "")
    try:
        return _phase_spawn(torch, np, mvt, hbm, ici, ring, a2a, smi, dev)
    finally:
        cfg.set("REDUCE_ALGO", saved)


def _phase_spawn(torch, np, mvt, hbm, ici, ring, a2a, smi, dev):
    from mvapich2_tpu_torch.core import status as pstat
    from mvapich2_tpu_torch.runtime import nameserv, spawn
    t_phase = time.perf_counter()
    mods = (hbm, ici, ring, a2a)
    on_cuda = dev.type == "cuda"
    card_dev = dev if on_cuda else torch.device("meta")
    big = SPAWN_SIZES[-1]
    gen = torch.Generator(device=dev).manual_seed(SEED + 2901)
    world_in = [torch.randint(-8, 8, (N,), generator=gen, device=dev,
                              dtype=torch.int32).float()
                for _ in range(SPAWN_PARENTS)]
    k1_want = hbm.fused_reduce_to_slot_ref(torch.stack(world_in).reshape(
        SPAWN_PARENTS, N // 128, 128)).reshape(N)
    child_out = {}

    def sync():
        if on_cuda:
            torch.cuda.current_stream().synchronize()

    def refusals(inter, merged):
        """A tensor on the card in a call on the intercomm and on the
        merged comm: NotImplementedError naming why, on every rank."""
        msgs = []
        for c in (inter, merged):
            try:
                c.allreduce(torch.ones(16, device=card_dev))
            except NotImplementedError as e:
                msgs.append(str(e))
                continue
            raise AssertionError(f"[spawn] a tensor on the card was taken "
                                 f"by {c.name}")
        if not all("not moved to the host" in m for m in msgs):
            raise AssertionError(f"[spawn] refusals {msgs}")
        return msgs

    def child(cw):
        parent = spawn.get_parent(cw.u)
        me = cw.u.world_rank
        times = _spawn_calls(np, parent, pstat, me,
                             list(parent.remote_group.world_ranks))
        _spawn_split(np, parent, me)
        merged = parent.merge(high=True)
        got = merged.allreduce(_spawn_vals(np, me, 20, big))
        for _ in range(SPAWN_ITERS):
            merged.allreduce(_spawn_vals(np, me, 20, big))
        want = sum(_spawn_vals(np, w, 20, big)
                   for w in range(SPAWN_PARENTS + SPAWN_CHILDREN))
        child_out[cw.rank] = (times, got.tobytes() == want.tobytes(),
                              refusals(parent, merged))
        merged.barrier()

    def parent(comm):
        me = comm.u.world_rank
        t0 = time.perf_counter()
        inter, codes = spawn.comm_spawn(comm, child,
                                        maxprocs=SPAWN_CHILDREN)
        spawn_ms = (time.perf_counter() - t0) * 1e3
        if any(codes) or inter.remote_size != SPAWN_CHILDREN:
            raise AssertionError(f"[spawn] codes {codes}, remote "
                                 f"{inter.remote_size}")
        times = _spawn_calls(np, inter, pstat, me,
                             list(inter.remote_group.world_ranks))
        split = _spawn_split(np, inter, me)
        merged = inter.merge(high=False)
        if (merged.rank, merged.size) != (comm.rank, SPAWN_PARENTS +
                                          SPAWN_CHILDREN):
            raise AssertionError(f"[spawn] merged rank {merged.rank} of "
                                 f"{merged.size}")
        got = merged.allreduce(_spawn_vals(np, me, 20, big))
        lat = []
        for _ in range(SPAWN_ITERS):
            t0 = time.perf_counter()
            merged.allreduce(_spawn_vals(np, me, 20, big))
            lat.append((time.perf_counter() - t0) * 1e3)
        want = sum(_spawn_vals(np, w, 20, big)
                   for w in range(SPAWN_PARENTS + SPAWN_CHILDREN))
        if got.tobytes() != want.tobytes():
            raise AssertionError("[spawn] merged 4 MiB allreduce: not "
                                 "bitwise numpy's")
        msgs = refusals(inter, merged)
        merged.barrier()
        comm.barrier()
        host_launches = dict(_launches(*mods)) if comm.rank == 0 else None
        # the parents' COMM_WORLD keeps its slot channel and K1
        comm.barrier()
        if comm.rank == 0:
            _zero(*mods)
        comm.barrier()
        out = comm.allreduce(world_in[comm.rank])
        sync()
        comm.barrier()
        k1 = dict(_launches(*mods)) if comm.rank == 0 else None
        return (spawn_ms, times, statistics.median(lat), msgs,
                host_launches, k1, out, split)

    _zero(*mods)
    t0 = time.perf_counter()
    res = mvt.run_ranks(SPAWN_PARENTS, parent, device=dev)
    thread_s = time.perf_counter() - t0
    if sorted(child_out) != list(range(SPAWN_CHILDREN)) or \
            not all(c[1] for c in child_out.values()):
        raise AssertionError(f"[spawn] children: {sorted(child_out)}")
    spawn_ms, times, merged_ms, msgs, host_launches, k1, out, split = \
        res[0]
    if any(host_launches.values()):
        raise AssertionError(f"[spawn] the intercomm calls launched "
                             f"{host_launches}")
    if k1 != _want(mods, fused_reduce_to_slot=1):
        raise AssertionError(f"[spawn] COMM_WORLD after the spawn: "
                             f"launches {k1}")
    for r in range(SPAWN_PARENTS):
        _exact(torch, "[spawn] COMM_WORLD 64 MiB allreduce after the "
               "spawn", res[r][6], k1_want)
    fmt = lambda d: ", ".join(f"{k} B {v:.3f}" for k, v in d.items())
    for op in SPAWN_OPS:
        log(f"[spawn] thread mode, {SPAWN_PARENTS} parents on {dev} + "
            f"{SPAWN_CHILDREN} spawned: intercomm {op} (ms, rank 0 host "
            f"clock, median of {SPAWN_ITERS}) {fmt(times[op])}; bitwise "
            f"numpy on every rank")
    log(f"[spawn] thread mode, the 4 MiB intercomm allreduce's parts "
        f"alone (ms, rank 0, median of {SPAWN_ITERS}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    log(f"[spawn] Comm_spawn of {SPAWN_CHILDREN} rank threads "
        f"{spawn_ms:.2f} ms; merge(high) 8-rank 4 MiB f32 allreduce "
        f"{merged_ms:.3f} ms (median of {SPAWN_ITERS}); a tensor on the "
        f"card refused by the intercomm and the merged comm on all 8 "
        f"ranks ({msgs[1][:120]}...); the intercomm calls launched "
        f"nothing; then COMM_WORLD's 64 MiB f32 allreduce: K1 "
        f"{k1['fused_reduce_to_slot']} launch, bitwise its plain "
        f"version; {thread_s:.1f} s on {smi}")

    svc = f"chip-smoke-{os.getpid()}"

    def ports(comm):
        server = comm.rank < R // 2
        local = comm.split(0 if server else 1, comm.rank)
        t0 = time.perf_counter()
        if server:
            port = "mv2t-port:0:0"       # significant at the root only
            if local.rank == 0:
                port = spawn.open_port(comm.u)
                nameserv.publish_name(comm.u, svc, port)
            comm.barrier()
            inter = spawn.comm_accept(port, local, 0)
        else:
            comm.barrier()
            port = nameserv.lookup_name(comm.u, svc)
            inter = spawn.comm_connect(port, local, 0)
        conn_ms = (time.perf_counter() - t0) * 1e3
        me = comm.u.world_rank
        remote = list(inter.remote_group.world_ranks)
        want = sum(_spawn_vals(np, q, 30, big) for q in remote)
        lat = []
        for i in range(1 + SPAWN_ITERS):
            t0 = time.perf_counter()
            got = inter.allreduce(_spawn_vals(np, me, 30, big))
            lat.append((time.perf_counter() - t0) * 1e3)
            if i == 0 and got.tobytes() != want.tobytes():
                raise AssertionError("[spawn] port intercomm allreduce: "
                                     "not bitwise numpy's")
        inter.disconnect()
        comm.barrier()
        if server and local.rank == 0:
            nameserv.unpublish_name(comm.u, svc)
            spawn.close_port(comm.u, port)
        return conn_ms, statistics.median(lat[1:])

    pres = mvt.run_ranks(R, ports, device=dev)
    conn_ms, port_ms = pres[0]
    log(f"[spawn] ports: {R // 2} ranks accept, {R // 2} connect through "
        f"the name service in {conn_ms:.2f} ms; intercomm 4 MiB f32 "
        f"allreduce {port_ms:.3f} ms (median of {SPAWN_ITERS}), bitwise "
        f"numpy; disconnect, unpublish on {smi}")

    job, wall = _mpirun_job(["-np", "2", sys.executable, SPAWN_PROG],
                            "SPAWN_JSON", expect="No Errors")
    deadline = time.monotonic() + 10
    while any(os.path.exists(f"/proc/{p}") and not _zombie(p)
              for p in job["child_pids"]) and time.monotonic() < deadline:
        time.sleep(0.05)
    alive = [p for p in job["child_pids"]
             if os.path.exists(f"/proc/{p}") and not _zombie(p)]
    if alive or len(job["child_pids"]) != 2:
        raise AssertionError(f"[spawn] spawned processes {alive} outlived "
                             f"the job ({job})")
    log(f"[spawn] process mode: mpirun -np 2 of {SPAWN_PROG} spawning 2 "
        f"children (appnum 0 and 1): job {wall:.2f} s, rank 0's "
        f"Comm_spawn {job['spawn_s']:.3f} s, intercomm allreduce 8 B "
        f"{job['allreduce_small_us']:.1f} us and 4 MiB "
        f"{job['allreduce_big_us'] / 1e3:.3f} ms (median of "
        f"{job['iters']}); No Errors, no child left on {smi}")
    total = time.perf_counter() - t_phase
    log(f"[spawn] phase {total:.1f} s")
    return {"thread": {"spawn_ms": spawn_ms, "intercomm_ms": times,
                       "allreduce_4MiB_parts_ms": split,
                       "merged_allreduce_4MiB_ms": merged_ms,
                       "refusals": msgs, "k1_after_spawn": k1,
                       "children": {r: c[0] for r, c in
                                    sorted(child_out.items())},
                       "run_s": thread_s},
            "ports": {"connect_ms": conn_ms, "allreduce_4MiB_ms": port_ms},
            "process": job, "process_job_s": wall, "phase_s": total}


def _zombie(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[-1].split()[0] == "Z"
    except OSError:
        return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the full report as JSON")
    ap.add_argument("--sweep", action="store_true",
                    help="run only the launch-shape sweeps of K9, of the "
                    "K12/K13 copy, of K11's tile size, of "
                    "K8's bulk-copy pipeline and of K1's pointer form "
                    "(after the device and build phases)")
    ap.add_argument("--sweeps", default=",".join(SWEEPS),
                    help="with --sweep, the sweeps to run, of "
                    + ", ".join(SWEEPS))
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
    from mvapich2_tpu_torch.bench import moe, osu_rma
    from mvapich2_tpu_torch.models import flash, ring_attention, ulysses
    from mvapich2_tpu_torch.ops import (_build, alltoall, collectives, hbm,
                                        ici, quant, ring, rma)
    from mvapich2_tpu_torch.parallel import MeshComm, make_mesh
    from mvapich2_tpu_torch.utils import detect, timing
    from mvapich2_tpu_torch.utils.config import get_config

    cfg = get_config()
    # the 4 KiB numpy reduces of [main] and [mesh] are below
    # DEVICE_COLL_MIN_BYTES, where MPI's reduce takes the host tier unless
    # the algorithm is forced onto the device: those phases count K1/K3
    # launches on them
    cfg.set("REDUCE_ALGO", "device")

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    name, smi = phase_device(torch)
    build_s = phase_build(_build)
    if args.sweep:
        from mvapich2_tpu_torch.coll import tuning
        sweeps = {
            "k9": lambda: phase_sweep(torch, ici, quant, ring, tuning,
                                      timing, _build, dev),
            "copy": lambda: phase_copy_sweep(torch, rma, tuning, timing,
                                             dev),
            "tile": lambda: phase_tile_sweep(torch, alltoall, moe, ring,
                                             timing, dev),
            "k8": lambda: phase_k8_sweep(torch, ici, ring, tuning, timing,
                                         dev),
            "k1": lambda: phase_k1_sweep(torch, hbm, tuning, timing, dev)}
        rows = []
        for key in args.sweeps.split(","):
            rows += sweeps[key]()
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"device": name, "nvidia_smi": smi, "rows": rows},
                          f, indent=1)
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        return 0
    flash_build = phase_flash_build(_build)
    full_err = phase_kernels(torch, np, hbm, dev)
    full_err.update(phase_k1_ptr_kernels(torch, np, hbm, dev))
    full_err.update(phase_ring_kernels(torch, np, ici, ring, dev))
    full_err.update(phase_rs_kernels(torch, np, ici, ring, dev))
    full_err.update(phase_a2a_kernels(torch, np, alltoall, ring, moe, dev))
    full_err.update(phase_rma_kernels(torch, np, rma, ring, dev))
    full_err.update(phase_quant_kernels(torch, np, quant, ici, rma, ring,
                                        cfg, dev))
    flash_err = phase_flash_kernels(torch, flash, dev)
    launches, slice_launches, lat, inputs = phase_main_path(
        torch, np, mvt, hbm, opmod, dev)
    mesh_launches, mesh_lat = phase_mesh(torch, np, mvt, ici, ring, mpit,
                                         opmod, dev, inputs)
    fold_launches, fold_lat = phase_fold(torch, np, mvt, ici, ring, hbm,
                                         alltoall, mpit, opmod, dev, inputs)
    mesh2d_launches, mesh2d_lat = phase_mesh2d(
        torch, np, mvt, ici, ring, hbm, alltoall, mpit, opmod, dev, inputs)
    k8_launches = phase_sendrecv(torch, ici, ring, dev, inputs)
    a2a_launches, a2a_lat = phase_mesh_a2a(torch, np, mvt, alltoall, ring,
                                           mpit, moe, dev)
    moe_art = phase_moe(torch, moe, alltoall, ring, dev)
    rma_launches, rma_art = phase_rma(torch, osu_rma, rma, ring, mpit, dev)
    k9_launches, q_lats = phase_quant(torch, np, mvt, quant, ici, ring, mpit,
                                      opmod, cfg, dev, inputs)
    k14q_launches = phase_rma_quant(torch, rma, ring, mpit, cfg, dev)
    attn_launches, attn_lat, attn_data = phase_attn(
        torch, flash, ring_attention, ulysses, MeshComm, make_mesh, dev)
    nbc = phase_nbc(torch, np, mvt, ici, ring, alltoall, mpit, cfg, moe, smi,
                    dev)
    host = phase_host(torch, np, mvt, hbm, ici, ring, alltoall, mpit, opmod,
                      cfg, smi, dev)
    info = detect.detect(dev)
    kernels, extra = phase_times(torch, hbm, timing, info, smi, inputs,
                                 lat, launches, full_err)
    ring_kernels, ring_extra = phase_ring_times(
        torch, np, ici, ring, timing, info, inputs, mesh_lat,
        mesh_launches, full_err)
    rs_kernels, rs_extra = phase_rs_times(
        torch, ici, ring, timing, info, inputs,
        {**mesh2d_launches, "remote_sendrecv":
         k8_launches["remote_sendrecv"]}, full_err,
        {"mesh_1d": mesh_lat[0], "fold": fold_lat, "mesh2d": mesh2d_lat})
    a2a_kernels, a2a_extra = phase_a2a_times(
        torch, alltoall, ring, moe, timing, info, a2a_lat, a2a_launches,
        full_err, dev)
    rma_kernels, rma_extra = phase_rma_times(
        torch, rma, ring, timing, info, rma_launches, full_err, rma_art, dev)
    quant_kernels, quant_extra = phase_quant_times(
        torch, quant, ici, rma, ring, timing, info, smi, cfg, k9_launches,
        k14q_launches, full_err, q_lats, mesh_lat, dev)
    attn_kernels, attn_extra = phase_attn_times(
        torch, flash, ulysses, collectives, timing, info, attn_launches,
        attn_lat, flash_err, attn_data)
    kernels += ring_kernels + rs_kernels + a2a_kernels + rma_kernels + \
        quant_kernels + attn_kernels
    extra.update(attn_extra)
    extra.update(quant_extra)
    extra.update(ring_extra)
    extra.update(rs_extra)
    extra.update(a2a_extra)
    extra.update(rma_extra)
    extra["flash_build"] = flash_build
    extra["nbc"] = nbc
    extra["host"] = host
    extra["rma_host_profile"] = phase_rma_host_profile(torch, dev)
    models_state, extra["models"] = phase_models(torch, np, ici, ring, hbm,
                                                 alltoall, smi, dev)
    extra["graft"] = phase_graft(torch, np, (hbm, ici, ring, alltoall), smi,
                                 dev)
    extra["mpirun"] = phase_mpirun(torch, smi, mesh_lat)
    extra["card_paths"] = phase_card_paths(
        torch, np, mvt, hbm, ici, ring, alltoall, rma, mpit, moe, MeshComm,
        make_mesh, timing, info, smi, dev)
    extra["derived"] = phase_derived(torch, np, mvt, hbm, ici, ring,
                                     alltoall, mpit, make_mesh, smi, dev)
    extra["spawn"] = phase_spawn(torch, np, mvt, hbm, ici, ring, alltoall,
                                 smi, dev)
    extra["trace"] = phase_trace(torch, np, mvt, mpit, cfg, smi, inputs, dev)
    moe_art["breakdown"] = phase_moe_profile(torch, moe, moe_art, dev)
    extra["osu_rma_breakdown"] = phase_rma_profile(torch, osu_rma, dev)
    extra["hier_breakdown"] = phase_hier_profile(
        torch, mvt, dev, inputs,
        {"slot": lat[0], "mesh_1d": mesh_lat[0], "fold": fold_lat,
         "mesh2d": mesh2d_lat})
    extra["attn_breakdown"] = phase_attn_profile(
        torch, ring_attention, ulysses, attn_lat, attn_data)
    extra["models_breakdown"] = phase_models_profile(torch, models_state)
    total_s = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": name, "nvidia_smi": smi,
                       "build_s": build_s, "total_s": total_s,
                       "slice_launches": slice_launches,
                       "mesh_launches": mesh_launches,
                       "fold_launches": fold_launches,
                       "mesh2d_launches": mesh2d_launches,
                       "sendrecv_launches": k8_launches,
                       "mesh_a2a_launches": a2a_launches,
                       "rma_launches": rma_launches,
                       "quant_launches": {"quant_ring_all_reduce":
                                          k9_launches,
                                          "rma_accumulate_quant":
                                          k14q_launches},
                       "attn_launches": attn_launches,
                       "moe": moe_art,
                       "kernels": kernels, **extra}, f, indent=1)
    log(f"[done] {total_s:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
