"""The host collective algorithms (a copy of the JAX package's
``coll/algorithms.py``): dissemination barrier; binomial and
scatter-ring-allgather bcast; binomial and order-preserving reduce;
recursive-doubling, ring, Rabenseifner (rsa), two-level and
gather-bcast allreduce; recursive-doubling, Bruck and ring allgather;
ring allgatherv; Bruck, scattered and pairwise alltoall; scattered
alltoallv; binomial gather and scatter; ring reduce-scatter; the
recursive-doubling scan. They run over the point-to-point protocol on
the comm's collective context, so user traffic never matches them, and
fold in the same order as the JAX package's, so the same inputs give
bit-identical results.

All functions operate on contiguous numpy arrays:
  * movement collectives take uint8 byte arrays (datatype already packed),
  * reductions take arrays of the datatype's basic dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.datatype import from_numpy_dtype
from ..core.op import Op
from ..core.request import waitall


# ---------------------------------------------------------------------------
# pt2pt helpers on the collective context
# ---------------------------------------------------------------------------

def csend(comm, buf: np.ndarray, dest: int, tag: int):
    return comm.u.protocol.isend(buf, buf.size, from_numpy_dtype(buf.dtype),
                                 comm.world_of(dest), comm.rank,
                                 comm.ctx_coll, tag)


def crecv(comm, buf: np.ndarray, src: int, tag: int):
    return comm.u.protocol.irecv(buf, buf.size, from_numpy_dtype(buf.dtype),
                                 src, comm.ctx_coll, tag)


def csendrecv(comm, sbuf: np.ndarray, dest: int, rbuf: np.ndarray, src: int,
              tag: int) -> None:
    rreq = crecv(comm, rbuf, src, tag)
    sreq = csend(comm, sbuf, dest, tag)
    rreq.wait()
    sreq.wait()


# ---------------------------------------------------------------------------
# barrier
# ---------------------------------------------------------------------------

def barrier_dissemination(comm, tag: int) -> None:
    """log2(p) rounds of token exchange (MPICH's dissemination barrier)."""
    size, rank = comm.size, comm.rank
    if size == 1:
        return
    token = np.zeros(1, dtype=np.uint8)
    rtoken = np.zeros(1, dtype=np.uint8)
    mask = 1
    while mask < size:
        dst = (rank + mask) % size
        src = (rank - mask) % size
        csendrecv(comm, token, dst, rtoken, src, tag)
        mask <<= 1


# ---------------------------------------------------------------------------
# bcast
# ---------------------------------------------------------------------------

def bcast_binomial(comm, data: np.ndarray, root: int, tag: int) -> None:
    """Binomial tree broadcast (MPIR_Bcast_binomial analog)."""
    size, rank = comm.size, comm.rank
    if size == 1:
        return
    vrank = (rank - root) % size
    # receive from parent
    mask = 1
    while mask < size:
        if vrank & mask:
            parent = ((vrank - mask) + root) % size
            crecv(comm, data, parent, tag).wait()
            break
        mask <<= 1
    # forward to children
    mask >>= 1
    reqs = []
    while mask > 0:
        if vrank + mask < size:
            child = (vrank + mask + root) % size
            reqs.append(csend(comm, data, child, tag))
        mask >>= 1
    waitall(reqs)


def bcast_scatter_ring_allgather(comm, data: np.ndarray, root: int,
                                 tag: int) -> None:
    """Large-message bcast: scatter + ring allgather
    (MPIR_Bcast_scatter_ring_allgather analog). Total traffic ~2n per link
    vs n*log(p) for the binomial tree."""
    size, rank = comm.size, comm.rank
    n = data.size
    if size == 1 or n < size:
        return bcast_binomial(comm, data, root, tag)
    counts, displs = _block_ranges(n, size)
    # scatter: root sends each rank its block (linear — same total bytes
    # from the root as a binomial scatter)
    if rank == root:
        reqs = [csend(comm, data[displs[r]:displs[r] + counts[r]], r, tag)
                for r in range(size) if r != root]
        waitall(reqs)
    else:
        crecv(comm, data[displs[rank]:displs[rank] + counts[rank]],
              root, tag).wait()
    # ring allgather of the blocks
    right, left = (rank + 1) % size, (rank - 1) % size
    for step in range(size - 1):
        sblk = (rank - step) % size
        rblk = (rank - step - 1) % size
        csendrecv(comm, data[displs[sblk]:displs[sblk] + counts[sblk]], right,
                  data[displs[rblk]:displs[rblk] + counts[rblk]], left, tag)


# ---------------------------------------------------------------------------
# reduce / allreduce
# ---------------------------------------------------------------------------

def reduce_binomial(comm, arr: np.ndarray, op: Op, root: int,
                    tag: int) -> Optional[np.ndarray]:
    """Binomial-tree reduce; returns result at root, None elsewhere.
    Commutative ops only (the tuning layer guards)."""
    size, rank = comm.size, comm.rank
    acc = arr.copy()
    if size == 1:
        return acc
    vrank = (rank - root) % size
    mask = 1
    tmp = np.empty_like(acc)
    while mask < size:
        if vrank & mask:
            parent = ((vrank - mask) + root) % size
            csend(comm, acc, parent, tag).wait()
            return None
        peer_v = vrank + mask
        if peer_v < size:
            crecv(comm, tmp, (peer_v + root) % size, tag).wait()
            acc = op(tmp, acc)
        mask <<= 1
    return acc


def allreduce_recursive_doubling(comm, arr: np.ndarray, op: Op,
                                 tag: int) -> np.ndarray:
    """MPIR_Allreduce_pt2pt_rd_MV2 analog (allreduce_osu.c:360)."""
    size, rank = comm.size, comm.rank
    acc = arr.copy()
    if size == 1:
        return acc
    # fold non-power-of-2 remainder into the lower power-of-2 set
    pof2 = 1 << (size.bit_length() - 1)
    if pof2 == size:
        rem = 0
    else:
        rem = size - pof2
    tmp = np.empty_like(acc)
    newrank = rank
    if rank < 2 * rem:
        if rank % 2 == 0:
            csend(comm, acc, rank + 1, tag).wait()
            newrank = -1
        else:
            crecv(comm, tmp, rank - 1, tag).wait()
            acc = op(tmp, acc)
            newrank = rank // 2
    elif rem:
        newrank = rank - rem
    if newrank != -1:
        mask = 1
        while mask < pof2:
            peer_new = newrank ^ mask
            peer = peer_new * 2 + 1 if peer_new < rem else peer_new + rem
            csendrecv(comm, acc, peer, tmp, peer, tag)
            acc = op(tmp, acc)
            mask <<= 1
    # send result back to the folded ranks
    if rank < 2 * rem:
        if rank % 2:
            csend(comm, acc, rank - 1, tag).wait()
        else:
            crecv(comm, acc, rank + 1, tag).wait()
    return acc


def _block_ranges(n: int, size: int):
    counts = [n // size + (1 if i < n % size else 0) for i in range(size)]
    displs = [0] * size
    for i in range(1, size):
        displs[i] = displs[i - 1] + counts[i - 1]
    return counts, displs


def allreduce_ring(comm, arr: np.ndarray, op: Op, tag: int) -> np.ndarray:
    """Ring reduce-scatter + ring allgather — the bandwidth-optimal path
    (MPIR_Allreduce_pt2pt_ring_MV2, allreduce_osu.c:3824). This is also
    exactly the skeleton XLA lowers psum to on an ICI ring."""
    size, rank = comm.size, comm.rank
    acc = arr.copy()
    if size == 1:
        return acc
    counts, displs = _block_ranges(acc.size, size)
    right = (rank + 1) % size
    left = (rank - 1) % size
    tmp = np.empty(max(counts) if counts else 0, dtype=acc.dtype)
    # reduce-scatter phase
    for step in range(size - 1):
        sblk = (rank - step) % size
        rblk = (rank - step - 1) % size
        sb = acc[displs[sblk]:displs[sblk] + counts[sblk]]
        rb = tmp[:counts[rblk]]
        csendrecv(comm, sb, right, rb, left, tag)
        dst = acc[displs[rblk]:displs[rblk] + counts[rblk]]
        dst[...] = op(rb, dst)
    # allgather phase
    for step in range(size - 1):
        sblk = (rank + 1 - step) % size
        rblk = (rank - step) % size
        sb = acc[displs[sblk]:displs[sblk] + counts[sblk]]
        rb = acc[displs[rblk]:displs[rblk] + counts[rblk]]
        csendrecv(comm, sb, right, rb, left, tag)
    return acc


def allreduce_reduce_scatter_allgather(comm, arr: np.ndarray, op: Op,
                                       tag: int) -> np.ndarray:
    """Rabenseifner: recursive-halving reduce-scatter + recursive-doubling
    allgather (allreduce_osu.c:633). Power-of-two comm sizes; the tuning
    layer falls back to rd otherwise."""
    size, rank = comm.size, comm.rank
    if size & (size - 1):
        return allreduce_recursive_doubling(comm, arr, op, tag)
    acc = arr.copy()
    if size == 1:
        return acc
    n = acc.size
    if n < size:
        return allreduce_recursive_doubling(comm, arr, op, tag)
    counts, displs = _block_ranges(n, size)
    # recursive halving reduce-scatter
    mask = size >> 1
    lo, hi = 0, size  # block range I still own
    while mask:
        peer = rank ^ mask
        mid = (lo + hi) // 2
        if rank & mask:
            keep_lo, keep_hi, give_lo, give_hi = mid, hi, lo, mid
        else:
            keep_lo, keep_hi, give_lo, give_hi = lo, mid, mid, hi
        gb0, gb1 = displs[give_lo], displs[give_hi - 1] + counts[give_hi - 1]
        kb0, kb1 = displs[keep_lo], displs[keep_hi - 1] + counts[keep_hi - 1]
        tmp = np.empty(kb1 - kb0, dtype=acc.dtype)
        csendrecv(comm, acc[gb0:gb1], peer, tmp, peer, tag)
        acc[kb0:kb1] = op(tmp, acc[kb0:kb1])
        lo, hi = keep_lo, keep_hi
        mask >>= 1
    # recursive doubling allgather
    mask = 1
    while mask < size:
        peer = rank ^ mask
        # my current range [lo,hi); peer holds the mirrored adjacent range
        span = hi - lo
        if rank & mask:
            plo, phi = lo - span, lo
        else:
            plo, phi = hi, hi + span
        mb0, mb1 = displs[lo], displs[hi - 1] + counts[hi - 1]
        pb0, pb1 = displs[plo], displs[phi - 1] + counts[phi - 1]
        csendrecv(comm, acc[mb0:mb1], peer, acc[pb0:pb1], peer, tag)
        lo, hi = min(lo, plo), max(hi, phi)
        mask <<= 1
    return acc


def allreduce_two_level(comm, arr: np.ndarray, op: Op, tag: int,
                        inter_algo=allreduce_recursive_doubling) -> np.ndarray:
    """Hierarchical: intra-node reduce -> inter-leader allreduce ->
    intra-node bcast (the shmem+leader two-level scheme,
    allreduce_osu.c:1482-1687 / create_2level_comm.c)."""
    shmem, leader = comm.build_2level()
    if shmem is None or shmem.size == comm.size:
        return inter_algo(comm, arr, op, tag)
    local = reduce_binomial(shmem, arr, op, 0, tag)
    if leader is not None:
        local = inter_algo(leader, local, op, tag)
    if local is None:
        local = np.empty_like(arr)
    bcast_binomial(shmem, local, 0, tag)
    return local


def reduce_gather_local(comm, arr: np.ndarray, op: Op, root: int,
                        tag: int) -> Optional[np.ndarray]:
    """Order-preserving reduce for non-commutative ops: gather all
    contributions to root and fold them in rank order."""
    size, rank = comm.size, comm.rank
    out = np.empty(size * arr.size, dtype=arr.dtype) if rank == root else None
    gather_binomial(comm, arr, out, root, tag)
    if rank != root:
        return None
    # MPI order: result = buf_0 ⊕ buf_1 ⊕ ... ⊕ buf_{p-1}, folded left.
    # Op convention is fn(invec, inout) -> invec ⊕ inout (invec earlier).
    acc = out[:arr.size].copy()
    for r in range(1, size):
        acc = op.fn(acc, out[r * arr.size:(r + 1) * arr.size])
    return acc


def allreduce_gather_bcast(comm, arr: np.ndarray, op: Op,
                           tag: int) -> np.ndarray:
    """Non-commutative-safe allreduce: ordered reduce at 0 + bcast."""
    res = reduce_gather_local(comm, arr, op, 0, tag)
    if res is None:
        res = np.empty_like(arr)
    bcast_binomial(comm, res, 0, tag)
    return res


# ---------------------------------------------------------------------------
# allgather
# ---------------------------------------------------------------------------

def allgather_ring(comm, mine: np.ndarray, out: np.ndarray,
                   tag: int) -> None:
    """Ring allgather (allgather_osu.c:1106)."""
    size, rank = comm.size, comm.rank
    nb = mine.size
    out[rank * nb:(rank + 1) * nb] = mine
    if size == 1:
        return
    right, left = (rank + 1) % size, (rank - 1) % size
    for step in range(size - 1):
        sblk = (rank - step) % size
        rblk = (rank - step - 1) % size
        csendrecv(comm, out[sblk * nb:(sblk + 1) * nb], right,
                  out[rblk * nb:(rblk + 1) * nb], left, tag)


def allgather_recursive_doubling(comm, mine: np.ndarray, out: np.ndarray,
                                 tag: int) -> None:
    """RD allgather for power-of-two sizes (allgather_osu.c:587)."""
    size, rank = comm.size, comm.rank
    if size & (size - 1):
        return allgather_bruck(comm, mine, out, tag)
    nb = mine.size
    out[rank * nb:(rank + 1) * nb] = mine
    mask = 1
    my_lo = rank
    span = 1
    while mask < size:
        peer = rank ^ mask
        # my_lo is always aligned to span == mask, so the peer's aligned
        # block range starts at my_lo ^ mask
        peer_lo = my_lo ^ mask
        sb = out[my_lo * nb:(my_lo + span) * nb]
        rb = out[peer_lo * nb:(peer_lo + span) * nb]
        csendrecv(comm, sb, peer, rb, peer, tag)
        my_lo = min(my_lo, peer_lo)
        span *= 2
        mask <<= 1


def allgather_bruck(comm, mine: np.ndarray, out: np.ndarray,
                    tag: int) -> None:
    """Bruck allgather: works for any comm size in ceil(log2 p) steps."""
    size, rank = comm.size, comm.rank
    nb = mine.size
    # local rotated accumulation: tmp holds blocks in order (rank, rank+1,..)
    tmp = np.empty(size * nb, dtype=mine.dtype)
    tmp[:nb] = mine
    have = 1
    pof2 = 1
    while pof2 < size:
        src = (rank + pof2) % size
        dst = (rank - pof2) % size
        cnt = min(pof2, size - have)
        rreq = crecv(comm, tmp[have * nb:(have + cnt) * nb], src, tag)
        sreq = csend(comm, tmp[:cnt * nb], dst, tag)
        rreq.wait()
        sreq.wait()
        have += cnt
        pof2 <<= 1
    # unrotate
    for i in range(size):
        out[((rank + i) % size) * nb:((rank + i) % size + 1) * nb] = \
            tmp[i * nb:(i + 1) * nb]


def allgatherv_ring(comm, mine: np.ndarray, out: np.ndarray,
                    counts: Sequence[int], displs: Sequence[int],
                    tag: int) -> None:
    size, rank = comm.size, comm.rank
    out[displs[rank]:displs[rank] + counts[rank]] = mine[:counts[rank]]
    if size == 1:
        return
    right, left = (rank + 1) % size, (rank - 1) % size
    for step in range(size - 1):
        sblk = (rank - step) % size
        rblk = (rank - step - 1) % size
        csendrecv(comm, out[displs[sblk]:displs[sblk] + counts[sblk]], right,
                  out[displs[rblk]:displs[rblk] + counts[rblk]], left, tag)


# ---------------------------------------------------------------------------
# alltoall
# ---------------------------------------------------------------------------

def alltoall_scattered(comm, sbuf: np.ndarray, rbuf: np.ndarray,
                       tag: int) -> None:
    """Post all isend/irecv at once (alltoall_osu.c scattered algo)."""
    size, rank = comm.size, comm.rank
    nb = sbuf.size // size
    reqs = []
    for i in range(1, size):
        src = (rank + i) % size
        reqs.append(crecv(comm, rbuf[src * nb:(src + 1) * nb], src, tag))
    for i in range(1, size):
        dst = (rank - i) % size
        reqs.append(csend(comm, sbuf[dst * nb:(dst + 1) * nb], dst, tag))
    rbuf[rank * nb:(rank + 1) * nb] = sbuf[rank * nb:(rank + 1) * nb]
    waitall(reqs)


def alltoall_pairwise(comm, sbuf: np.ndarray, rbuf: np.ndarray,
                      tag: int) -> None:
    """Pairwise exchange: p-1 sendrecv steps, bandwidth-friendly for large
    messages (alltoall_osu.c pairwise algo)."""
    size, rank = comm.size, comm.rank
    nb = sbuf.size // size
    rbuf[rank * nb:(rank + 1) * nb] = sbuf[rank * nb:(rank + 1) * nb]
    is_pof2 = (size & (size - 1)) == 0
    for i in range(1, size):
        if is_pof2:
            send_peer = recv_peer = rank ^ i
        else:
            send_peer = (rank + i) % size
            recv_peer = (rank - i) % size
        csendrecv(comm, sbuf[send_peer * nb:(send_peer + 1) * nb], send_peer,
                  rbuf[recv_peer * nb:(recv_peer + 1) * nb], recv_peer, tag)


def alltoall_bruck(comm, sbuf: np.ndarray, rbuf: np.ndarray,
                   tag: int) -> None:
    """Bruck alltoall: log2(p) steps for small messages."""
    size, rank = comm.size, comm.rank
    nb = sbuf.size // size
    # phase 1: local rotation
    tmp = np.concatenate([sbuf[rank * nb:], sbuf[:rank * nb]]).copy()
    # phase 2: log steps — send blocks whose bit k of (block index) is set
    pof2 = 1
    while pof2 < size:
        idxs = [b for b in range(size) if b & pof2]
        sel = np.concatenate([tmp[b * nb:(b + 1) * nb] for b in idxs])
        dst = (rank + pof2) % size
        src = (rank - pof2) % size
        rcv = np.empty_like(sel)
        csendrecv(comm, sel, dst, rcv, src, tag)
        for j, b in enumerate(idxs):
            tmp[b * nb:(b + 1) * nb] = rcv[j * nb:(j + 1) * nb]
        pof2 <<= 1
    # phase 3: inverse rotation + reversal
    for b in range(size):
        srcr = (rank - b) % size
        rbuf[srcr * nb:(srcr + 1) * nb] = tmp[b * nb:(b + 1) * nb]


def alltoallv_scattered(comm, sbuf, scounts, sdispls, rbuf, rcounts, rdispls,
                        tag: int) -> None:
    size, rank = comm.size, comm.rank
    reqs = []
    for i in range(size):
        if i == rank:
            continue
        reqs.append(crecv(comm, rbuf[rdispls[i]:rdispls[i] + rcounts[i]],
                          i, tag))
    for i in range(size):
        if i == rank:
            continue
        reqs.append(csend(comm, sbuf[sdispls[i]:sdispls[i] + scounts[i]],
                          i, tag))
    rbuf[rdispls[rank]:rdispls[rank] + rcounts[rank]] = \
        sbuf[sdispls[rank]:sdispls[rank] + scounts[rank]]
    waitall(reqs)


# ---------------------------------------------------------------------------
# gather / scatter
# ---------------------------------------------------------------------------

def gather_binomial(comm, mine: np.ndarray, out: Optional[np.ndarray],
                    root: int, tag: int) -> None:
    """Binomial gather: subtree data travels in one message per link."""
    size, rank = comm.size, comm.rank
    nb = mine.size
    vrank = (rank - root) % size
    # my subtree spans vranks [vrank, vrank + span)
    span = 1
    while not (vrank & span) and span < size:
        span <<= 1
    span = min(span, size - vrank)
    stage = np.empty(span * nb, dtype=mine.dtype)
    stage[:nb] = mine
    # collect from children
    mask = 1
    while mask < span:
        child_v = vrank + mask
        if child_v < size:
            cnt = min(mask, size - child_v)
            crecv(comm, stage[mask * nb:(mask + cnt) * nb],
                  (child_v + root) % size, tag).wait()
        mask <<= 1
    if vrank == 0:
        # stage holds blocks in vrank order; unrotate to comm-rank order
        for v in range(size):
            r = (v + root) % size
            out[r * nb:(r + 1) * nb] = stage[v * nb:(v + 1) * nb]
    else:
        parent_v = vrank & (vrank - 1)  # clear lowest set bit
        csend(comm, stage, (parent_v + root) % size, tag).wait()


def scatter_binomial(comm, sendbuf: Optional[np.ndarray], mine: np.ndarray,
                     root: int, tag: int) -> None:
    """Binomial scatter — the inverse tree of gather_binomial."""
    size, rank = comm.size, comm.rank
    nb = mine.size
    vrank = (rank - root) % size
    if vrank == 0:
        # rotate into vrank order; subtree span is the whole comm
        stage = np.empty(size * nb, dtype=mine.dtype)
        for v in range(size):
            r = (v + root) % size
            stage[v * nb:(v + 1) * nb] = sendbuf[r * nb:(r + 1) * nb]
        top = 1
        while top < size:
            top <<= 1
    else:
        # my subtree spans vranks [vrank, vrank + lowbit(vrank)), clipped
        # to the comm; the FAN-OUT width must stay the unclipped power
        # of two — clipping it skips intermediate children (size=7:
        # v4's span clips to 3, top=3 started the child loop at mask=1
        # and never fed v6, deadlocking every 7-rank scatter)
        width = vrank & (-vrank)
        span = min(width, size - vrank)
        stage = np.empty(span * nb, dtype=mine.dtype)
        parent_v = vrank & (vrank - 1)
        crecv(comm, stage, (parent_v + root) % size, tag).wait()
        top = width
    # forward child subtrees, largest offset first (matches gather order)
    mask = top >> 1
    while mask >= 1:
        child_v = vrank + mask
        if child_v < size:
            cnt = min(mask, size - child_v)
            csend(comm, stage[mask * nb:(mask + cnt) * nb],
                  (child_v + root) % size, tag).wait()
        mask >>= 1
    mine[...] = stage[:nb]


# ---------------------------------------------------------------------------
# reduce_scatter / scan
# ---------------------------------------------------------------------------

def reduce_scatter_ring(comm, arr: np.ndarray, out: np.ndarray, op: Op,
                        tag: int) -> None:
    """Ring reduce-scatter with equal blocks (block variant)."""
    size, rank = comm.size, comm.rank
    nb = out.size
    if size == 1:
        out[...] = arr[:nb]
        return
    acc = arr.copy()
    right, left = (rank + 1) % size, (rank - 1) % size
    tmp = np.empty(nb, dtype=arr.dtype)
    # step s: pass partial for block (rank-s-1) rightward, fold the partial
    # for block (rank-s-2) from the left; after size-1 steps my fully
    # reduced block is block `rank`.
    for step in range(size - 1):
        sblk = (rank - step - 1) % size
        rblk = (rank - step - 2) % size
        csendrecv(comm, acc[sblk * nb:(sblk + 1) * nb], right, tmp, left, tag)
        dst = acc[rblk * nb:(rblk + 1) * nb]
        dst[...] = op(tmp, dst)
    out[...] = acc[rank * nb:(rank + 1) * nb]


def scan_linear(comm, arr: np.ndarray, op: Op, tag: int,
                exclusive: bool = False) -> np.ndarray:
    """Recursive-doubling inclusive/exclusive scan (MPIR_Scan analog)."""
    size, rank = comm.size, comm.rank
    partial = arr.copy()          # scan of my group so far
    result = arr.copy()           # prefix ending at me
    tmp = np.empty_like(arr)
    mask = 1
    while mask < size:
        peer = rank ^ mask
        if peer < size:
            csendrecv(comm, partial, peer, tmp, peer, tag)
            # fold in rank order: op.fn(invec, inout) = invec ⊕ inout with
            # invec the earlier operand — matters for non-commutative ops
            if peer < rank:
                partial = op.fn(tmp, partial)
                result = op.fn(tmp, result)
            else:
                partial = op.fn(partial, tmp)
        mask <<= 1
    if not exclusive:
        return result
    # exclusive: shift — rank r needs scan of ranks [0, r)
    ex = np.empty_like(arr)
    if rank < size - 1:
        csend(comm, result, rank + 1, tag + 1).wait()
    if rank > 0:
        crecv(comm, ex, rank - 1, tag + 1).wait()
    else:
        # rank 0's exclusive-scan result is undefined by MPI; zero it
        ex[...] = np.zeros_like(ex)
    return ex
