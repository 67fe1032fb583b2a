"""On-device bitstream packing (JAX): prefix-sum pack without scatters.

Every residual section is a sequence of codewords, each of which is a run of
leading zeros followed by a short (<= 32-bit) tail. Packing therefore reduces
to: compute each tail's absolute bit offset (cumulative sums), split each tail
into contributions to (at most) two consecutive 32-bit output words, and then
materialize each output word as a *difference of prefix sums* — codeword
offsets are monotone, so all contributions to a word form a contiguous range:

    word[w] = CUM[hi(w)] - CUM[lo(w)]      (wrapping int32 arithmetic; bit
                                            ranges are disjoint, so sum == or)

with hi/lo found by a vectorized binary search. This replaces the byte-serial
bit_stream engine of classic codecs with cumsum + searchsorted + gather —
vectorized array primitives (BASELINE.json: "vectorized codeword-length
computation plus prefix-sum bitstream pack").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (CODER_LOG2_MAX_NUM_PARTITIONS,
                         CODER_RICE_PARAMETER_BITS)


def _plane_sum(word_ids: jnp.ndarray, values: jnp.ndarray, W: int):
    """Per-row: sum `values` into W bins (bit-disjoint, so sum == or).

    Entries with id >= W are dropped. Batched scatter-add with the
    sorted-indices hint (ids are monotone per row).
    """
    V = word_ids.shape[0]
    buf = jnp.zeros((V, W + 1), jnp.uint32)
    ids = jnp.minimum(word_ids, W)
    # NOTE: do NOT pass indices_are_sorted=True: the indices are not sorted
    # across rows, and the plain scatter is correct at all sizes.
    buf = buf.at[jnp.arange(V)[:, None], ids].add(values)
    return buf[:, :W]


def _word_splits(offsets, tails, tbits, W: int):
    """Per-entry word index and the two word-aligned contributions."""
    offsets = offsets.astype(jnp.int32)
    tails = tails.astype(jnp.uint32)
    tbits = tbits.astype(jnp.int32)
    valid = tbits > 0
    limit = W * 32
    offsets = jnp.where(valid, jnp.minimum(offsets, limit), limit)
    w0 = offsets >> 5
    sh = offsets & 31
    # First word holds the tail's high (tbits - over) bits; `over` spill bits
    # go to the top of the next word.
    over = jnp.maximum(tbits - (32 - sh), 0)
    keep = tbits - over
    vA = (tails >> over.astype(jnp.uint32)) << (32 - sh - keep).astype(jnp.uint32)
    vA = jnp.where(valid & (keep > 0), vA, 0)
    ov_nz = over > 0
    vB = jnp.where(ov_nz,
                   (tails << (32 - jnp.maximum(over, 1)).astype(jnp.uint32)),
                   0)
    vB = jnp.where(valid, vB, 0)
    return w0.astype(jnp.int32), vA, vB


def _boundary_search(w0: jnp.ndarray, W: int) -> jnp.ndarray:
    """F[:, j] = #entries with w0 < j, for j = 0..W+1 (w0 monotone per row).

    Vectorized binary search: ~log2(T) rounds of take_along_axis gathers —
    no scatters."""
    V, T = w0.shape
    j = jnp.arange(W + 2, dtype=jnp.int32)[None, :]
    lo = jnp.zeros((V, W + 2), jnp.int32)
    hi = jnp.full((V, W + 2), T, jnp.int32)
    for _ in range(max(1, int(np.ceil(np.log2(max(T, 2)))) + 1)):
        mid = (lo + hi) >> 1
        vals = jnp.take_along_axis(w0, jnp.minimum(mid, T - 1), axis=1)
        less = vals < j
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where(less, hi, mid)
    return hi


def _pack_block(offsets, tails, tbits, W: int, G: int = 64, A: int = 64):
    """Scatter-free packer: dense grouped-window packing + prefix combine.

    This formulation uses only elementwise ops, cumulative sums, and a
    handful of contiguous gathers:

      1. Entries are cut into groups of G consecutive codewords. Each group
         densely packs its (<= 2 per entry) word contributions into a 2A-word
         frame anchored at the A-aligned block containing its first word —
         order within a frame is irrelevant (bit ranges are disjoint, sum==or)
         so the pack is a masked reduction over the group axis, not a scatter.
      2. Because offsets are monotone, the groups anchored at block b form a
         CONTIGUOUS group range; out[b*A + j] is therefore a difference of
         group-axis prefix sums of the frames, evaluated at the block's
         boundary group indices (one small take_along_axis per block), plus
         the [A, 2A) spill half of the previous block's range.

    A group whose contributions overflow its 2A frame (a pathological
    codeword run) cannot be represented; those rows are reported in the
    returned per-row `overflow` mask and must be packed elsewhere (the
    encoder re-encodes them on the host).

    Returns (words (B, W) uint32, overflow (B,) bool).
    """
    w0, vA, vB = _word_splits(offsets, tails, tbits, W)
    V, T = w0.shape
    valid = tbits > 0
    Tp = ((T + G - 1) // G) * G
    if Tp != T:
        pad = ((0, 0), (0, Tp - T))
        w0 = jnp.pad(w0, pad, constant_values=W)
        vA = jnp.pad(vA, pad)
        vB = jnp.pad(vB, pad)
        valid = jnp.pad(valid, pad)
    ng = Tp // G
    nblocks = (W + A - 1) // A + 1
    w0g = w0.reshape(V, ng, G)
    validg = valid.reshape(V, ng, G)
    vAg = jnp.where(validg, vA.reshape(V, ng, G), 0)
    vBg = jnp.where(validg, vB.reshape(V, ng, G), 0)

    # Anchor block of each group: A-aligned block of its first valid word.
    first_w = jnp.min(jnp.where(validg, w0g, W * 2), axis=2)    # (V, ng)
    blk0 = jnp.where(first_w >= W, nblocks + 1, first_w // A)
    loc = w0g - (blk0 * A)[:, :, None]                           # frame coords
    okA = validg & (loc >= 0) & (loc < 2 * A)
    okB = validg & (loc + 1 >= 0) & (loc + 1 < 2 * A)
    # Frame overflow: a valid contribution falls outside [0, 2A).
    overflow = jnp.any(validg & (w0g < W) & ((loc < 0) | (loc + 1 >= 2 * A)),
                       axis=(1, 2))

    # Dense local pack: frame[v, g, j] = sum of contributions at frame word j.
    frames = []
    locB = loc + 1
    for j in range(2 * A):
        fj = (jnp.sum(jnp.where(okA & (loc == j), vAg, 0), axis=2)
              + jnp.sum(jnp.where(okB & (locB == j), vBg, 0), axis=2))
        frames.append(fj)
    frame = jnp.stack(frames, axis=2)                            # (V, ng, 2A)

    # Group-axis prefix sums (exclusive), with a trailing total row.
    cums = jnp.concatenate(
        [jnp.zeros((V, 1, 2 * A), jnp.uint32),
         jnp.cumsum(frame, axis=1, dtype=jnp.uint32)], axis=1)   # (V, ng+1, 2A)

    # F[b] = #groups with blk0 < b  (blk0 monotone per row).
    b_idx = jnp.arange(nblocks + 1, dtype=jnp.int32)
    F = jnp.sum(blk0[:, None, :] < b_idx[None, :, None],
                axis=2).astype(jnp.int32)                        # (V, nb+1)
    # Boundary prefix planes: P[b] = cums[F[b]]  -> (V, nb+1, 2A).
    P = jnp.take_along_axis(cums, F[:, :, None], axis=1)
    own = P[:, 1:, :A] - P[:, :-1, :A]                           # blk0 == b
    spill = P[:, :-1, A:] - jnp.concatenate(
        [P[:, :1, A:], P[:, :-2, A:]], axis=1)                   # blk0 == b-1
    out = (own + spill).reshape(V, nblocks * A)[:, :W]
    return out, overflow


def pack_flat_stream(offsets: jnp.ndarray, tails: jnp.ndarray,
                     tbits: jnp.ndarray, cap_w: int,
                     G: int = 64, A: int = 64):
    """Scatter-free pack of one globally monotone codeword stream into a
    single (cap_w,) uint32 buffer (grouped-window + prefix combine — the
    _pack_block scheme generalized to absolute offsets, which lets the
    caller pack every row's section at its final position and skip the
    row-compaction pass).

    offsets: (R, T) absolute bit positions, non-decreasing along the
    FLATTENED (R*T,) order — including masked slots (tbits == 0), whose
    offsets must carry the running cursor (residual_codewords does this);
    rows are bit-disjoint spans of the output. Entries with offset >=
    cap_w*32 are dropped.

    Returns (flat (cap_w,) uint32, group_overflow (R, T//G) bool): a True
    group had a contribution outside its 2A-word frame (pathologically long
    codeword run) and its rows' sections are NOT fully packed — the caller
    must re-encode them elsewhere and not consume these bytes.
    """
    R, T = offsets.shape
    assert T % G == 0, "caller pads T to a multiple of G"
    _, vA, vB = _word_splits(offsets.reshape(1, R * T),
                             tails.reshape(1, R * T),
                             tbits.reshape(1, R * T), cap_w)
    # Word index from the RAW offsets: _word_splits moves masked slots to
    # the buffer limit, which would turn fully-masked groups (allzero rows,
    # skipped rows, tail padding) into out-of-order sentinels and break the
    # non-decreasing blk0 the prefix combine requires. Masked slots carry
    # the running cursor and zero contributions, so keeping their true word
    # only steers the group anchor.
    w0 = (jnp.minimum(offsets.reshape(1, R * T).astype(jnp.int32),
                      cap_w * 32) >> 5)
    valid = tbits.reshape(1, R * T) > 0
    ng = (R * T) // G
    nblocks = (cap_w + A - 1) // A + 1
    w0g = w0.reshape(ng, G)
    validg = valid.reshape(ng, G)
    vAg = jnp.where(validg, vA.reshape(ng, G), 0)
    vBg = jnp.where(validg, vB.reshape(ng, G), 0)

    # Anchor block of each group: A-aligned block of its first word. Uses
    # ALL slots (not just valid ones) — masked slots carry the monotone
    # cursor, so min == first, and blk0 stays non-decreasing over groups,
    # which the prefix-combine below requires.
    first_w = jnp.min(w0g, axis=1)                               # (ng,)
    blk0 = jnp.minimum(first_w // A, nblocks - 1)
    loc = w0g - (blk0 * A)[:, None]                              # frame coords
    okA = validg & (loc >= 0) & (loc < 2 * A)
    okB = validg & (loc + 1 >= 0) & (loc + 1 < 2 * A)
    overflow = jnp.any(validg & (w0g < cap_w)
                       & ((loc < 0) | (loc + 1 >= 2 * A)), axis=1)

    # Dense local pack: frame[g, j] = sum of contributions at frame word j
    # (bit-disjoint, so sum == or).
    locB = loc + 1
    frames = []
    for j in range(2 * A):
        fj = (jnp.sum(jnp.where(okA & (loc == j), vAg, 0), axis=1)
              + jnp.sum(jnp.where(okB & (locB == j), vBg, 0), axis=1))
        frames.append(fj)
    frame = jnp.stack(frames, axis=1)                            # (ng, 2A)

    cums = jnp.concatenate(
        [jnp.zeros((1, 2 * A), jnp.uint32),
         jnp.cumsum(frame, axis=0, dtype=jnp.uint32)], axis=0)   # (ng+1, 2A)

    # F[b] = #groups with blk0 < b (blk0 non-decreasing): binary search.
    b_idx = jnp.arange(nblocks + 1, dtype=jnp.int32)
    lo = jnp.zeros(nblocks + 1, jnp.int32)
    hi = jnp.full(nblocks + 1, ng, jnp.int32)
    for _ in range(max(1, int(np.ceil(np.log2(max(ng, 2)))) + 1)):
        mid = (lo + hi) >> 1
        less = blk0[jnp.minimum(mid, ng - 1)] < b_idx
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where(less, hi, mid)
    F = hi                                                       # (nb+1,)
    P = cums[F]                                                  # (nb+1, 2A)
    own = P[1:, :A] - P[:-1, :A]                                 # blk0 == b
    spill = P[:-1, A:] - jnp.concatenate([P[:1, A:], P[:-2, A:]], axis=0)
    flat = (own + spill).reshape(nblocks * A)[:cap_w]
    return flat, overflow.reshape(R, T // G)


def pack_monotone_stream(offsets: jnp.ndarray, tails: jnp.ndarray,
                         tbits: jnp.ndarray, W: int,
                         impl: str = "scatter") -> jnp.ndarray:
    """Pack one stream of codeword tails into (B, W) uint32 words (MSB-first).

    offsets: (B, T) absolute bit positions of each tail, non-decreasing along
    T. tails: (B, T) uint32 (low `tbits` bits significant). tbits: (B, T),
    0 = masked slot. Entries with offset >= W*32 are dropped.

    word[w] is materialized as a difference of (wrapping int32) prefix sums:
    contributions to one word are bit-disjoint, so their true sum fits 32
    bits and sum == or; entries for word w form the contiguous index range
    [F[w], F[w+1]) because offsets are monotone.
    """
    w0, vA, vB = _word_splits(offsets, tails, tbits, W)
    if impl == "scatter":
        planeA = _plane_sum(w0, vA, W)
        planeB = _plane_sum(jnp.minimum(w0 + 1, W), vB, W)
        return planeA + planeB
    EA = jnp.cumsum(vA.astype(jnp.int32), axis=1)
    EB = jnp.cumsum(vB.astype(jnp.int32), axis=1)
    zero = jnp.zeros((w0.shape[0], 1), jnp.int32)
    EA = jnp.concatenate([zero, EA], axis=1)   # EA[t] = sum vA[:t]
    EB = jnp.concatenate([zero, EB], axis=1)
    F = _boundary_search(w0, W)                # (V, W+2)
    wordA = (jnp.take_along_axis(EA, F[:, 1:W + 1], axis=1)
             - jnp.take_along_axis(EA, F[:, :W], axis=1))
    # Spill plane: ids are w0 + 1, so word w collects [F[w-1], F[w]).
    Fm1 = jnp.concatenate([F[:, :1], F[:, :W - 1]], axis=1)
    wordB = (jnp.take_along_axis(EB, F[:, :W], axis=1)
             - jnp.take_along_axis(EB, Fm1, axis=1))
    return (wordA + wordB).astype(jnp.uint32)


def residual_codewords(u: jnp.ndarray, code_type: jnp.ndarray,
                       porder: jnp.ndarray, ks: jnp.ndarray, n: int):
    """Per-variant codeword decomposition of the residual section as ONE
    merged monotone stream in natural bit order (header, then per partition
    its parameter codeword followed by its samples).

    u: (V, n) uint32 zigzag residuals; code_type (V,); porder (V,);
    ks (V, 1024). Returns ((offsets, tails, tbits), total_bits) where the
    stream arrays are (V, 2 + 1024 + n); slot e >= 2 maps per row to
    partition part = (e-2) // (nsmpl+1): its parameter when
    (e-2) % (nsmpl+1) == 0, else sample part*nsmpl + within - 1. Masked
    slots carry tbits == 0. Consecutive slots are bit-adjacent, which the
    grouped-window packer's locality argument relies on.

    Section layout parity: libs/srla_coder/src/srla_coder.c:486-595.
    """
    V = u.shape[0]
    allzero = code_type == 2
    recursive = code_type == 1

    s_idx = jnp.arange(n, dtype=jnp.int32)[None, :]
    nsmpl = (n >> porder)[:, None]                   # (V, 1)
    part_of_sample = s_idx // nsmpl                  # (V, n)
    k = jnp.take_along_axis(ks, part_of_sample, axis=1).astype(jnp.int32)
    ku = k.astype(jnp.uint32)

    ui = u.astype(jnp.uint32)
    mask = (jnp.uint32(1) << ku) - jnp.uint32(1)
    # Plain Rice: q zeros, 1, k low bits.
    q_r = (ui >> ku).astype(jnp.int32)
    tail_r = (jnp.uint32(1) << ku) | (ui & mask)
    tb_r = k + 1
    # Recursive Rice: small -> 1 + k1 bits; big -> q' zeros, 1, k2 bits.
    k1pow = jnp.uint32(1) << (ku + 1)
    small = ui < k1pow
    tmp = jnp.where(small, 0, ui - k1pow)
    q_rr = jnp.where(small, 0, 1 + (tmp >> ku).astype(jnp.int32))
    tail_rr = jnp.where(small, k1pow | ui, (jnp.uint32(1) << ku) | (tmp & mask))
    tb_rr = jnp.where(small, k + 2, k + 1)

    s_lead = jnp.where(recursive[:, None], q_rr, q_r)
    s_tails = jnp.where(recursive[:, None], tail_rr, tail_r)
    s_tbits = jnp.where(recursive[:, None], tb_rr, tb_r)
    s_tbits = jnp.where(allzero[:, None], 0, s_tbits)

    # Partition parameter codewords: 5-bit k, then unary zigzag deltas.
    MAXP = ks.shape[1]
    nparts = (jnp.int32(1) << porder)
    pidx = jnp.arange(MAXP, dtype=jnp.int32)[None, :]
    pactive = (pidx < nparts[:, None]) & ~allzero[:, None]
    ks32 = ks.astype(jnp.int32)
    prev = jnp.concatenate([ks32[:, :1], ks32[:, :-1]], axis=1)
    diff = ks32 - prev
    udiff = (((-(diff < 0).astype(jnp.int32)) ^ (diff << 1))
             .astype(jnp.int32))
    p_lead = jnp.where(pactive & (pidx > 0), udiff, 0)
    p_tails = jnp.where(pidx == 0, ks32, 1).astype(jnp.uint32)
    p_tbits = jnp.where(pactive,
                        jnp.where(pidx == 0, CODER_RICE_PARAMETER_BITS, 1), 0)

    # Merge into natural bit order. Slot map (per row, nsmpl+1 period).
    T = 2 + MAXP + n
    e = jnp.arange(T - 2, dtype=jnp.int32)[None, :]  # slots after the header
    period = nsmpl + 1                               # (V, 1)
    part = e // period                               # (V, T-2)
    within = e - part * period
    is_param = within == 0
    live = part < nparts[:, None]
    partc = jnp.minimum(part, MAXP - 1)
    sidx = jnp.minimum(part * nsmpl + within - 1, n - 1)
    sidxc = jnp.maximum(sidx, 0)

    def pick(pv, sv):
        return jnp.where(is_param,
                         jnp.take_along_axis(pv, partc, axis=1),
                         jnp.take_along_axis(sv, sidxc, axis=1))

    lead = jnp.where(live, pick(p_lead, s_lead), 0)
    tails = jnp.where(live, pick(p_tails.astype(jnp.uint32),
                                 s_tails.astype(jnp.uint32)), 0)
    tbits = jnp.where(live, pick(p_tbits, s_tbits), 0)

    # Header slots: type (2b) + porder (10b); ALLZERO emits only the type.
    h_lead = jnp.zeros((V, 2), jnp.int32)
    h_tails = jnp.stack([code_type.astype(jnp.uint32),
                         porder.astype(jnp.uint32)], axis=1)
    h_tbits = jnp.stack([jnp.full((V,), 2, jnp.int32),
                         jnp.where(allzero, 0,
                                   CODER_LOG2_MAX_NUM_PARTITIONS)], axis=1)
    lead = jnp.concatenate([h_lead, lead], axis=1)
    tails = jnp.concatenate([h_tails, tails], axis=1)
    tbits = jnp.concatenate([h_tbits, tbits], axis=1)

    bits = lead + tbits
    csum = jnp.cumsum(bits, axis=1)
    offsets = (csum - bits) + lead                   # tail start positions
    total_bits = csum[:, -1]
    return (offsets, tails, tbits), total_bits


def pack_residual_sections(u, code_type, porder, ks, n: int, W: int,
                           impl: str = "scatter"):
    """Pack every variant's residual section into (V, W) uint32 + bit counts
    (+ a per-variant overflow mask: rows the packer could not represent and
    the caller must pack elsewhere — always all-False for the scatter/prefix
    impls, which have no frame limit)."""
    stream, total = residual_codewords(u, code_type, porder, ks, n)
    if impl == "block":
        words, ovf = _pack_block(*stream, W)
        return words, total, ovf
    words = pack_monotone_stream(*stream, W, impl)
    return words, total, jnp.zeros(words.shape[0], bool)
