"""Device decode, word-streaming design.

The round-2 decoder ran one lax.scan step per SAMPLE, each step gathering
from a (B, bits) NEXT_ONE table — gather-latency-bound at ~10-100 us/step.
This redesign removes every in-step gather:

1. ENTROPY: one lax.scan step per 32-bit payload WORD. The step body is the
   complete partitioned-Rice stream state machine (channel headers, partition
   parameter deltas, plain/recursive Rice codewords) unrolled over the word's
   32 bits — pure elementwise integer ops on (B,) vectors, the word itself
   arrives as the scan xs (no gather). Each step emits the ≤32 codeword
   values completed inside the word plus a completion bitmask.
   (Replaces the byte-serial reader loop of libs/bit_stream/include/
   bit_stream.h:357-397 + libs/srla_coder/src/srla_coder.c:598-698 with a
   vectorized transducer over the block axis.)
2. COMPACTION: completions are in stream order == (channel, sample) order,
   so residuals are recovered with a per-word-count cumsum, a batched binary
   search (word of the d-th completion), a 5-step bit-select (position of
   the r-th set bit in the word's completion mask), and one batched gather —
   no scatter.
3. SYNTHESIS: the LPC recurrence over samples (rows = block x channel) with
   de-emphasis fused — one in-kernel loop on the GPU (kernels/pallas_lpc.py),
   a lax.scan elsewhere; long-term prediction runs as a chunked scan (the
   LTP delay is >= 8, so 7 samples resolve per step).
   (Parity: srla_decoder/src/srla_lpc_synthesize.c:8-327,
   srla_utility.c:361-378, srla_decoder.c:436-595.)

Integer semantics are identical to the host oracle (srla_tpu/rice.py
decode + dsp/predict.py): uint32 wraparound everywhere, x86 shift masking
for the rshift-0 half constant. Corrupt-but-checksum-colliding payloads
produce garbage samples but never unbounded loops or OOB access (all
shifts/indices clipped) — the host caller checksum-verifies each block.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import LTP_COEFFICIENT_BITWIDTH

# Stream state-machine modes.
_M_CTYPE = 0    # collecting the 2-bit code type
_M_PORDER = 1   # collecting the 10-bit partition order
_M_K0 = 2       # collecting the 5-bit first Rice parameter
_M_UNARY = 3    # counting a sample codeword's unary run
_M_TAIL = 4     # collecting a sample codeword's k(-or-k+1)-bit tail
_M_UDELTA = 5   # counting a partition-parameter unary zigzag delta
_M_DONE = 6

_LTP_RSHIFT = LTP_COEFFICIENT_BITWIDTH - 1
_LTP_RING = 512          # > LTP max delay (262+1) rounded to a lane multiple
_LTP_CHUNK = 7           # min over valid streams of (delay - order + 1)


def _machine_bit(st, bit, n, C):
    """Advance the Rice-stream state machine by one bit.

    st is a dict of (B,) int32 registers; returns (st, completed_mask,
    completed_value). Exactly one 'event' can fire per bit (modes are
    mutually exclusive), so the where-chains commute.
    """
    mode, need, acc, k, rec = st["mode"], st["need"], st["acc"], st["k"], st["rec"]
    q, nlc, nlp, nsmpl, chan, azm = (st["q"], st["nlc"], st["nlp"],
                                     st["nsmpl"], st["chan"], st["azm"])
    one = bit == 1
    is_coll = (mode == _M_CTYPE) | (mode == _M_PORDER) | (mode == _M_K0) \
        | (mode == _M_TAIL)
    is_un = (mode == _M_UNARY) | (mode == _M_UDELTA)
    q = jnp.where(is_un & (~one), q + 1, q)
    acc = jnp.where(is_coll, (acc << 1) | bit, acc)
    need = jnp.where(is_coll, need - 1, need)
    cdone = is_coll & (need == 0)

    ctype_done = cdone & (mode == _M_CTYPE)
    ctype = acc & 3
    az = ctype_done & (ctype == 2)
    rec = jnp.where(ctype_done, (ctype == 1).astype(jnp.int32), rec)
    azm = jnp.where(az, azm | (jnp.int32(1) << jnp.clip(chan, 0, 30)), azm)

    pdone = cdone & (mode == _M_PORDER)
    porder = jnp.clip(acc, 0, 31)
    nsmpl = jnp.where(pdone, jnp.maximum(jnp.int32(n) >> porder, 1), nsmpl)

    kdone = cdone & (mode == _M_K0)
    k = jnp.where(kdone, acc & 31, k)

    term = is_un & one
    samp_term = term & (mode == _M_UNARY)
    qz = q == 0
    tw = jnp.where(rec == 1, jnp.where(qz, k + 1, k), k)
    tail0 = samp_term & (tw == 0)
    tdone = cdone & (mode == _M_TAIL)
    comp = tail0 | tdone

    # Codeword value (uint32 wraparound == host's int64-then-truncate).
    accu = jnp.where(tail0, 0, acc).astype(jnp.uint32)
    qq = q.astype(jnp.uint32)
    ku = jnp.clip(k, 0, 31).astype(jnp.uint32)
    u_rec = accu | ((qq + (q > 0).astype(jnp.uint32)) << ku)
    u_pl = (qq << ku) + accu
    u = jnp.where(rec == 1, u_rec, u_pl)

    delta_term = term & (mode == _M_UDELTA)
    dz = (q >> 1) ^ -(q & 1)
    k = jnp.where(delta_term, jnp.clip(k + dz, 0, 31), k)

    nlc = jnp.where(comp, nlc - 1, nlc)
    nlp = jnp.where(comp, nlp - 1, nlp)
    chan_fin = (comp & (nlc == 0)) | az
    part_fin = comp & (nlp == 0) & (~chan_fin)

    mode = jnp.where(ctype_done & (~az), _M_PORDER, mode)
    need = jnp.where(ctype_done & (~az), 10, need)
    mode = jnp.where(pdone, _M_K0, mode)
    need = jnp.where(pdone, 5, need)
    mode = jnp.where(kdone, _M_UNARY, mode)
    nlp = jnp.where(kdone, nsmpl, nlp)
    mode = jnp.where(samp_term & (~tail0), _M_TAIL, mode)
    need = jnp.where(samp_term & (~tail0), tw, need)
    mode = jnp.where(delta_term, _M_UNARY, mode)
    nlp = jnp.where(delta_term, nsmpl, nlp)
    mode = jnp.where(comp & (~chan_fin) & (~part_fin), _M_UNARY, mode)
    mode = jnp.where(part_fin, _M_UDELTA, mode)
    chan = jnp.where(chan_fin, chan + 1, chan)
    all_done = chan >= C
    mode = jnp.where(chan_fin, jnp.where(all_done, _M_DONE, _M_CTYPE), mode)
    need = jnp.where(chan_fin & (~all_done), 2, need)
    nlc = jnp.where(chan_fin, n, nlc)
    acc = jnp.where(ctype_done | pdone | kdone | samp_term | comp, 0, acc)
    # q survives the TAIL mode (the completed value needs the quotient);
    # it resets at sample completion and after a partition-delta codeword.
    q = jnp.where(comp | delta_term, 0, q)

    st = dict(mode=mode, need=need, acc=acc, k=k, rec=rec, q=q, nlc=nlc,
              nlp=nlp, nsmpl=nsmpl, chan=chan, azm=azm)
    return st, comp, u


_ST_KEYS = ("mode", "need", "acc", "k", "rec", "q", "nlc", "nlp", "nsmpl",
            "chan", "azm")
_LANE = jnp.arange(32, dtype=jnp.int32)

# Completion-window geometry. Each entropy-scan step consumes _WIN_WORDS
# payload words and snapshots a _WIN-lane window — wider windows cut the
# residual-assembly gather count (binary-search probes and row-slice
# fetches scale with Cn/_WIN).
_WIN_WORDS = 4
_WIN = 32 * _WIN_WORDS


def _butterfly_concentrate(v: jnp.ndarray, ok: jnp.ndarray):
    """Stable-compact the valid lanes of v (B, L) to the left (ok: bool).

    Self-routing reverse-banyan concentrator: route each valid element by
    the bits of its rank (count of valid lanes below it), LSB stage first.
    Concentration maps are conflict-free on this network for any power-of-
    two lane count (verified exhaustively at 16 lanes + randomized at
    32/128 lanes). Unclaimed lanes carry garbage; the caller masks by
    count."""
    B, L = v.shape
    lane = jnp.arange(L, dtype=jnp.int32)
    oki = ok.astype(jnp.int32)
    d = jnp.cumsum(oki, axis=1) - oki             # rank among valid lanes

    def swap(x, k):
        return x.reshape(B, -1, 2, k)[:, :, ::-1, :].reshape(B, L)

    k = 1
    while k < L:
        pv, pd, pok = swap(v, k), swap(d, k), swap(ok, k)
        is_hi = (lane & k) != 0
        keep = ok & (((d & k) != 0) == is_hi)
        take = pok & (((pd & k) != 0) == is_hi)
        v = jnp.where(keep, v, pv)
        d = jnp.where(keep, d, pd)
        ok = keep | take
        k *= 2
    return v


def _rotate_lanes(x: jnp.ndarray, s: jnp.ndarray):
    """Per-row circular right-rotation of L lanes by s (B,) via log2(L)
    conditional static rolls (lane-dynamic shifts would need a gather)."""
    k = 1
    while k < x.shape[1]:
        x = jnp.where((s[:, None] & k) != 0, jnp.roll(x, k, axis=1), x)
        k *= 2
    return x


def _window_update(prev, cur, cnt, vals, ok):
    """Merge one step's completions (vals (B, L) in stream order, ok valid
    mask) into the rolling mod-L completion window `cur`; archive `cur`
    into `prev` when the completion count crosses a multiple of L (a step
    completes at most L codewords, so at most one crossing per step)."""
    L = vals.shape[1]
    lane = jnp.arange(L, dtype=jnp.int32)
    shift = L.bit_length() - 1
    count = jnp.sum(ok.astype(jnp.int32), axis=1)
    comp = _butterfly_concentrate(vals, ok)
    s0 = cnt & (L - 1)
    rot = _rotate_lanes(comp, s0)
    r = (lane[None, :] - s0[:, None]) & (L - 1)   # rank landing on each lane
    occupied = r < count[:, None]
    cnt_new = cnt + count
    crossed = (cnt_new >> shift) > (cnt >> shift)
    pre = occupied & (r < (L - s0)[:, None])      # d < next L-boundary
    cur_mid = jnp.where(pre, rot, cur)
    prev = jnp.where(crossed[:, None], cur_mid, prev)
    cur = jnp.where(occupied, rot, cur)
    return prev, cur, cnt_new, count


def _entropy_scan(wordsT: jnp.ndarray, n: int, C: int,
                  unroll_bits: bool | None = None):
    """wordsT: (W, B) uint32, already left-shifted so the first channel's
    code-type field starts at bit 0.

    Returns (snap (WQ+1, B, _WIN) int32, counts (WQ, B) int32, azmask
    (B,)) where WQ = ceil(W / _WIN_WORDS). snap[t] is the _WIN-lane window
    of the last completed window as of step t (the d-th completion lives in
    lane d%_WIN of snap[t_d] where t_d is the first step with cumulative
    count > d rounded up to the window end); row WQ is a virtual final step
    exposing the trailing partial window. This emission shape makes
    residual assembly gather-free except one aligned row-slice fetch per
    _WIN outputs (see _assemble).

    unroll_bits=None takes the platform's choice (_unroll_bits_default).
    """
    if unroll_bits is None:
        unroll_bits = _unroll_bits_default()
    W, B = wordsT.shape
    pad = (-W) % _WIN_WORDS
    if pad:
        # Zero padding words are no-ops: finished rows sit in _M_DONE and a
        # zero bit in UNARY/UDELTA only grows the (discarded) run counter.
        wordsT = jnp.concatenate(
            [wordsT, jnp.zeros((pad, B), wordsT.dtype)], axis=0)
    quads = wordsT.reshape(-1, _WIN_WORDS, B)
    z = jnp.zeros((B,), jnp.int32)
    init_m = dict(mode=z + _M_CTYPE, need=z + 2, acc=z, k=z, rec=z, q=z,
                  nlc=z + n, nlp=z + 1, nsmpl=z + 1, chan=z, azm=z)
    zw = jnp.zeros((B, _WIN), jnp.int32)

    def bits_unrolled(st, w):
        vals = []
        cm = jnp.zeros((B,), jnp.uint32)
        for i in range(32):
            bit = ((w >> np.uint32(31 - i)) & np.uint32(1)).astype(jnp.int32)
            st, comp, u = _machine_bit(st, bit, n, C)
            vals.append(jnp.where(comp, u, jnp.uint32(0)).astype(jnp.int32))
            cm = cm | jnp.where(comp, jnp.uint32(1) << np.uint32(i),
                                jnp.uint32(0))
        return st, jnp.stack(vals, axis=1), cm

    def bits_rolled(st, w):
        def body(i, carry):
            st_t, vals, cm = carry
            st_d = dict(zip(_ST_KEYS, st_t))
            iu = i.astype(jnp.uint32)
            bit = ((w >> (31 - iu)) & np.uint32(1)).astype(jnp.int32)
            st_d, comp, u = _machine_bit(st_d, bit, n, C)
            v = jnp.where(comp, u, jnp.uint32(0)).astype(jnp.int32)
            vals = jax.lax.dynamic_update_slice(vals, v[:, None],
                                                (jnp.int32(0), i))
            cm = cm | jnp.where(comp, jnp.uint32(1) << iu, jnp.uint32(0))
            return tuple(st_d[k] for k in _ST_KEYS), vals, cm
        st_t, vals, cm = jax.lax.fori_loop(
            0, 32, body, (tuple(st[k] for k in _ST_KEYS),
                          jnp.zeros((B, 32), jnp.int32),
                          jnp.zeros((B,), jnp.uint32)))
        return dict(zip(_ST_KEYS, st_t)), vals, cm

    bits = bits_unrolled if unroll_bits else bits_rolled

    def inner(st_t, w):
        st, vals, cm = bits(dict(zip(_ST_KEYS, st_t)), w)
        ok = ((cm[:, None] >> _LANE.astype(jnp.uint32)[None, :])
              & jnp.uint32(1)) == 1
        return tuple(st[k] for k in _ST_KEYS), (vals, ok)

    def step(carry, wq):
        # One step = _WIN_WORDS payload words. The word machine stays a
        # rolled inner scan so the compiled body is one word wide.
        st_t, prev, cur, cnt = carry
        st_t, (vals, ok) = jax.lax.scan(inner, st_t, wq)
        vals = vals.transpose(1, 0, 2).reshape(B, _WIN)
        ok = ok.transpose(1, 0, 2).reshape(B, _WIN)
        prev, cur, cnt, count = _window_update(prev, cur, cnt, vals, ok)
        return (st_t, prev, cur, cnt), (prev, count)

    init = (tuple(init_m[k] for k in _ST_KEYS), zw, zw, z)
    (st_t, prev, cur, cnt), (snap, counts) = jax.lax.scan(step, init, quads)
    st = dict(zip(_ST_KEYS, st_t))
    snap = jnp.concatenate([snap, cur[None]], axis=0)   # virtual final step
    return snap, counts, st["azm"]


def _assemble(snap: "jnp.ndarray", counts: "jnp.ndarray",
              azmask: "jnp.ndarray", n: int, C: int):
    """Snapshot assembly: (W+1, B, L) windows + per-step counts ->
    residuals (B, C, n) int32. Gather-free except ONE aligned (1, L)
    row-slice fetch per L outputs (L=128 lanes cuts the probe and fetch
    count 4x vs 32).

    Output d (completion order) lives in lane d%L of snap[t_d] where
    t_d = first step with cumulative count >= L*(d//L + 1) (binary
    search over NJ windows, not Cn outputs); the trailing partial window
    reads the virtual final row W. ALLZERO channels emit nothing, so
    channel c's samples occupy d in [n * #non-az-channels-before-c, +n);
    the channel realignment is a static select over <= C shifted slices
    (per-row dynamic offsets would be a gather again).
    """
    Wp1, B, LN = snap.shape
    W = Wp1 - 1
    cum = jnp.cumsum(counts.T, axis=1)                      # (B, W)
    Cn = C * n
    NJ = -(-Cn // LN)

    # t_j = first step with cum >= L(j+1), else W (virtual row).
    tj = (jnp.arange(NJ, dtype=jnp.int32)[None, :] + 1) * LN
    lo = jnp.zeros((B, NJ), jnp.int32)
    hi = jnp.full((B, NJ), W, jnp.int32)
    for _ in range(max(int(np.ceil(np.log2(max(W + 1, 2)))), 1)):
        mid = (lo + hi) >> 1
        v = jnp.take_along_axis(cum, jnp.clip(mid, 0, W - 1), axis=1)
        go_hi = (v < tj) & (mid < W)
        lo = jnp.where(go_hi, mid + 1, lo)
        hi = jnp.where(go_hi, hi, mid)
    t = lo                                                   # (B, NJ)

    # Aligned row-slice fetch of the NJ snapshots per row.
    snapR = snap.reshape(Wp1 * B, LN)
    rows = (t * B + jnp.arange(B, dtype=jnp.int32)[:, None]).reshape(-1, 1)
    gd = jax.lax.GatherDimensionNumbers(
        offset_dims=(1, 2), collapsed_slice_dims=(), start_index_map=(0,))
    dense = jax.lax.gather(snapR, rows, gd, slice_sizes=(1, LN),
                           indices_are_sorted=False, unique_indices=False)
    dense = dense.reshape(B, NJ * LN)

    ui = dense.astype(jnp.int32)
    res = (ui >> 1) ^ -(ui & 1)                              # unzigzag

    # Channel realignment over ALLZERO gaps (static shifts, per-row select).
    az = ((azmask[:, None] >> jnp.arange(C)[None, :]) & 1) == 1
    if C == 1:
        out = jnp.where(az[:, :, None], 0, res[:, :n][:, None, :])
        return out
    nza = jnp.cumsum(jnp.where(az, 0, 1), axis=1) - jnp.where(az, 0, 1)
    chans = []
    for c in range(C):
        acc = jnp.zeros((B, n), jnp.int32)
        for k in range(c + 1):
            seg = jax.lax.dynamic_slice_in_dim(res, k * n, n, axis=1)
            acc = jnp.where((nza[:, c] == k)[:, None], seg, acc)
        chans.append(jnp.where(az[:, c][:, None], 0, acc))
    return jnp.stack(chans, axis=1)                          # (B, C, n)


def _byteswap32(w: jnp.ndarray) -> jnp.ndarray:
    """uint32 byte reversal (stream bytes are MSB-first; the host uploads
    the raw little-endian uint32 view to avoid a host-side staging pass)."""
    return (((w & jnp.uint32(0xFF)) << 24)
            | ((w & jnp.uint32(0xFF00)) << 8)
            | ((w >> 8) & jnp.uint32(0xFF00))
            | (w >> 24))


def _stage_from_flat(flat: jnp.ndarray, word_start: jnp.ndarray,
                     bit_rem: jnp.ndarray, W: int):
    """Per-row (W+1)-word slice gather straight out of the uploaded stream,
    byteswap, and left-shift so each block's first residual bit lands at
    bit 0. Replaces the host staging loop + padded (B, W) upload: the
    stream is uploaded ONCE at its exact size (paged, see driver) and
    block windows are cut on device."""
    B = word_start.shape[0]
    gd = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(), start_index_map=(0,))
    sl = jax.lax.gather(flat, word_start.reshape(B, 1), gd,
                        slice_sizes=(W + 1,), indices_are_sorted=False,
                        unique_indices=False)
    sl = _byteswap32(sl)
    w0, w1 = sl[:, :W], sl[:, 1:W + 1]
    b = bit_rem[:, None].astype(jnp.uint32)
    rs = jnp.where(b == 0, jnp.uint32(1), 32 - b)
    return jnp.where(b == 0, w0, (w0 << b) | (w1 >> rs))


# Packed per-block metadata layout (one H2D transfer instead of eleven
# small ones).
def _meta_cols(C: int, M: int, L: int):
    cols = {}
    o = 0
    for name, width in (("word_start", 1), ("bit_rem", 1), ("method", 1),
                        ("orders", C), ("rshifts", C), ("coefs", C * M),
                        ("ltp_orders", C), ("ltp_periods", C),
                        ("ltp_coefs", C * L), ("pre_coef", C),
                        ("pre_prev", C)):
        cols[name] = (o, width)
        o += width
    return cols, o


def pack_meta(pp: dict, sel, word_start, bit_rem, Bp: int, C: int, M: int,
              L: int):
    """Host-side: pack the per-block decode parameters into one (Bp, K)
    int32 array matching _meta_cols."""
    cols, K = _meta_cols(C, M, L)
    meta = np.zeros((Bp, K), np.int32)
    B = len(sel)

    def put(name, arr):
        o, w = cols[name]
        meta[:B, o:o + w] = arr.reshape(B, w)
    put("word_start", word_start)
    put("bit_rem", bit_rem)
    put("method", pp["method"][sel])
    put("orders", pp["orders"][sel])
    put("rshifts", pp["rshifts"][sel])
    put("coefs", pp["coefs"][sel][:, :, :M])
    put("ltp_orders", pp["ltp_orders"][sel])
    put("ltp_periods", pp["ltp_periods"][sel])
    put("ltp_coefs", pp["ltp_coefs"][sel][:, :, :L])
    put("pre_coef", pp["pre_coef"][sel])
    put("pre_prev", pp["pre_prev"][sel])
    return meta


@partial(jax.jit, static_argnames=("n", "C", "M", "W", "has_ltp"))
def decode_blocks_paged(pages, meta, lshift, *, n: int, C: int, M: int,
                        W: int, has_ltp: bool):
    """Fused device decode of one equal-size block group, stream-resident.

    pages: tuple of equal-length (P,) uint32 arrays — the raw .srl bytes as
    a little-endian uint32 view, split into fixed pages (trailing pages may
    be a shared all-zero buffer, uploaded once per process). meta: (Bp, K)
    int32 packed per-block parameters (pack_meta). Compile key is
    (page count, Bp, W, n, C, M) — all bucketed by the driver.

    Returns pcm (Bp, C, n) int32 with stereo inverse and offset lshift
    applied; rows past the real block count hold garbage (callers slice).
    """
    flat = jnp.concatenate(pages) if len(pages) > 1 else pages[0]
    cols, _K = _meta_cols(C, M, _MAX_LTP_C)

    def col(name, shape=None):
        o, w = cols[name]
        v = meta[:, o:o + w]
        return v.reshape((meta.shape[0],) + shape) if shape else v[:, 0]

    word_start = jnp.clip(col("word_start"), 0, flat.shape[0] - (W + 1))
    sw = _stage_from_flat(flat, word_start, col("bit_rem"), W)
    snap, counts, azmask = _entropy_scan(sw.T, n, C)
    res = _assemble(snap, counts, azmask, n, C)          # (B, C, n)
    return _synthesize(res, col("orders", (C,)), col("rshifts", (C,)),
                       col("coefs", (C, M)), col("ltp_orders", (C,)),
                       col("ltp_periods", (C,)),
                       col("ltp_coefs", (C, _MAX_LTP_C)),
                       col("pre_coef", (C,)), col("pre_prev", (C,)),
                       col("method"), lshift, n=n, C=C, M=M,
                       has_ltp=has_ltp)


_MAX_LTP_C = 3                      # MAX_LTP_ORDER (srla_internal.h:27-35)


def _unroll_bits_default() -> bool:
    """Platform choice for the entropy scan's 32-bit machine body.

    On the GPU the body is unrolled: rolled, it nests a 32-trip while loop
    inside every scan step, and XLA:GPU pays a launch per trip (PERF.md
    has the A/B). On the CPU it stays rolled, where the unrolled body takes
    minutes of XLA:CPU compile per shape."""
    return jax.default_backend() == "gpu"


def _lpc_impl_default() -> str:
    """Platform choice for the synthesis recurrence: the Pallas kernel on
    the GPU (one launch for all n samples), the XLA scan elsewhere."""
    return "kernel" if jax.default_backend() == "gpu" else "scan"


def _lpc(res, aligned, orders, rshifts, n, M, dcoef=None, dprev=None, *,
         impl, mesh=None):
    """The LPC recurrence by `impl`: "scan" (_lpc_scan, the reference),
    "kernel" (kernels/pallas_lpc.py compiled for the GPU) or "interpret"
    (the same kernel interpreted, for CPU tests). Under a mesh the kernel
    runs per shard of the row axis (rows are independent)."""
    if impl == "scan":
        return _lpc_scan(res, aligned, orders, rshifts, n, M, dcoef=dcoef,
                         dprev=dprev)
    from .pallas_lpc import lpc_synthesis
    fuse = dcoef is not None

    def call(r, a, o, s, dc, dp):
        return lpc_synthesis(r, a, o, s, n, M, dc if fuse else None,
                             dp if fuse else None,
                             interpret=impl == "interpret")

    z = jnp.zeros_like(orders)
    args = (res, aligned, orders, rshifts, dcoef if fuse else z,
            dprev if fuse else z)
    if mesh is None or res.shape[0] % mesh.devices.size:
        return call(*args)
    from jax.sharding import PartitionSpec as P
    ax = mesh.axis_names[0]
    return jax.shard_map(
        call, mesh=mesh,
        in_specs=(P(ax, None), P(ax, None), P(ax), P(ax), P(ax), P(ax)),
        out_specs=P(ax, None), check_vma=False)(*args)


def _synthesize(res, orders, rshifts, coefs, ltp_orders, ltp_periods,
                ltp_coefs, pre_coef, pre_prev, methods, lshift, *, n, C, M,
                has_ltp, lpc_impl=None, mesh=None):
    """Shared synthesis tail: LPC recurrence (+fused de-emphasis), optional
    LTP pass, stereo inverse, offset shift. lpc_impl=None takes the
    platform's choice (_lpc_impl_default)."""
    impl = lpc_impl or _lpc_impl_default()
    B = res.shape[0]
    R = B * C
    resR = res.reshape(R, n)
    ordR = orders.reshape(R)
    rshR = rshifts.reshape(R)
    aligned = _align_coefs(coefs.reshape(R, -1)[:, :M], ordR, M)
    dcoef = pre_coef.reshape(R)
    dprev = pre_prev.reshape(R).astype(jnp.int32)
    if has_ltp:
        v = _lpc(resR, aligned, ordR, rshR, n, M, impl=impl, mesh=mesh)
        y = _ltp_pass(v, ltp_orders.reshape(R), ltp_periods.reshape(R),
                      ltp_coefs.reshape(R, -1), n)
        if impl == "scan":
            y = _deemph_scan(y, dcoef, dprev)
        else:
            # De-emphasis alone is the order-0 recurrence with the fused
            # de-emphasis, so the kernel runs it too.
            zR = jnp.zeros((R,), jnp.int32)
            y = _lpc(y, jnp.zeros((R, 1), jnp.int32), zR, zR, n, 1,
                     dcoef, dprev, impl=impl, mesh=mesh)
    else:
        y = _lpc(resR, aligned, ordR, rshR, n, M, dcoef=dcoef, dprev=dprev,
                 impl=impl, mesh=mesh)
    out = y.reshape(B, C, n)

    if C >= 2:
        m = methods[:, None]
        c0, c1 = out[:, 0], out[:, 1]
        c0_ms = c0 - (c1 >> 1)
        c0 = jnp.where(m == 1, c0_ms, c0)
        c1 = jnp.where(m == 1, c1 + c0_ms, c1)
        c1 = jnp.where(m == 2, out[:, 1] + out[:, 0], c1)
        c0 = jnp.where(m == 3, out[:, 1] - out[:, 0], c0)
        out = jnp.concatenate([c0[:, None], c1[:, None], out[:, 2:]], axis=1)
    return out << lshift


def _shift_to_start(words: jnp.ndarray, start_bits: jnp.ndarray):
    """Left-shift each row's bitstream so start_bits lands at bit 0.

    One W+1-wide slice gather per ROW (per-index gather cost makes a
    per-element formulation ~150 ms at file scale; this is ~1300 indices),
    then an elementwise bit mix."""
    B, W = words.shape
    # Pad with W+1 zero words so the (1, W+1) slice below stays in bounds
    # for every word offset 0..W-1 (XLA gather CLAMPS out-of-bounds starts;
    # with a short pad every start_bits >= 64 silently read offset 1).
    wpad = jnp.concatenate([words, jnp.zeros((B, W + 1), jnp.uint32)], axis=1)
    wsh = (start_bits >> 5).reshape(-1, 1)
    bb = jnp.arange(B, dtype=jnp.int32).reshape(-1, 1)
    gd = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(0,), start_index_map=(0, 1))
    sl = jax.lax.gather(wpad, jnp.concatenate([bb, wsh], axis=1), gd,
                        slice_sizes=(1, W + 1), indices_are_sorted=False,
                        unique_indices=False)
    w0, w1 = sl[:, :W], sl[:, 1:W + 1]
    b = (start_bits & 31)[:, None].astype(jnp.uint32)
    rs = jnp.where(b == 0, jnp.uint32(1), 32 - b)
    return jnp.where(b == 0, w0, (w0 << b) | (w1 >> rs))


def _align_coefs(coefs: jnp.ndarray, orders: jnp.ndarray, M: int):
    """Right-align per-row coefficients for the window dot (col j multiplies
    the output M-orders+j steps back)."""
    j = jnp.arange(M)[None, :]
    cols = j - (M - orders)[:, None]
    return jnp.where(cols >= 0,
                     jnp.take_along_axis(coefs, jnp.clip(cols, 0, M - 1),
                                         axis=1), 0)


def _lpc_scan(res: jnp.ndarray, aligned: jnp.ndarray, orders: jnp.ndarray,
              rshifts: jnp.ndarray, n: int, M: int,
              dcoef=None, dprev=None):
    """Rows = block*channel. If dcoef is given, de-emphasis is fused."""
    R = res.shape[0]
    half = jnp.where(rshifts > 0, jnp.int32(1) << jnp.maximum(rshifts - 1, 0),
                     jnp.int32(-2147483648))
    active = orders > 0
    fuse = dcoef is not None

    def step(carry, xs):
        win, s, yprev = carry
        x = xs
        acc = jnp.sum(win * aligned, axis=1) + half
        pred = acc >> rshifts
        nv = jnp.where(s == 0, x,
                       jnp.where(s < orders, x + win[:, -1], x - pred))
        nv = jnp.where(active, nv, x)
        win = jnp.concatenate([win[:, 1:], nv[:, None]], axis=1)
        if fuse:
            y = nv + ((yprev * dcoef) >> 4)
            return (win, s + 1, y), y
        return (win, s + 1, yprev), nv

    init = (jnp.zeros((R, M), jnp.int32), jnp.int32(0),
            dprev if fuse else jnp.zeros((R,), jnp.int32))
    _, out = jax.lax.scan(step, init, res.T)
    return out.T


def _deemph_scan(x: jnp.ndarray, dcoef: jnp.ndarray, dprev: jnp.ndarray):
    def step(yprev, v):
        y = v + ((yprev * dcoef) >> 4)
        return y, y
    _, out = jax.lax.scan(step, dprev, x.T)
    return out.T


def _ltp_pass(v: jnp.ndarray, lorders: jnp.ndarray, lperiods: jnp.ndarray,
              lcoefs: jnp.ndarray, n: int):
    """Chunked LTP synthesis: y[s] = v[s] + ((half + sum c_i * y[s-delay+i])
    >> 5) for s >= delay+1; rows with period 0 pass through. The minimum
    delay is 8, so _LTP_CHUNK samples resolve per step from the ring of
    already-final outputs (ring kept right-aligned: slot 511 = newest)."""
    R = v.shape[0]
    maxo = lcoefs.shape[1]
    delay = lperiods + (lorders >> 1)
    on = (lperiods > 0) & (lorders > 0)
    half = jnp.int32(1 << (_LTP_RSHIFT - 1))
    nchunks = -(-n // _LTP_CHUNK)
    pad = nchunks * _LTP_CHUNK - n
    vp = jnp.pad(v, ((0, 0), (0, pad)))
    # At the START of step t the ring holds y[t*CHUNK - 512 .. t*CHUNK - 1]
    # (slot p = y[t*CHUNK - 512 + p]). Computing y[t*CHUNK + j] reads
    # y[t*CHUNK + j - delay + i] -> slot 512 + j - delay + i, constant per
    # row; delay >= 8 > j - i keeps every read strictly before the chunk.
    j = jnp.arange(_LTP_CHUNK)[None, :, None]
    i = jnp.arange(maxo)[None, None, :]
    slot = 512 + j - delay[:, None, None] + i
    slot = jnp.clip(slot, 0, _LTP_RING - 1).reshape(R, _LTP_CHUNK * maxo)
    imask = jnp.broadcast_to(i < lorders[:, None, None],
                             (R, _LTP_CHUNK, maxo)).reshape(
                                 R, _LTP_CHUNK * maxo)
    cexp = jnp.tile(lcoefs, (1, _LTP_CHUNK)) * imask
    sbase = jnp.arange(nchunks, dtype=jnp.int32) * _LTP_CHUNK

    def step(ring, xs):
        sb, vx = xs                       # vx (R, CHUNK)
        g = jnp.take_along_axis(ring, slot, axis=1)
        acc = half + jnp.sum((g * cexp).reshape(R, _LTP_CHUNK, maxo), axis=2)
        yv = vx + (acc >> _LTP_RSHIFT)
        sidx = sb + jnp.arange(_LTP_CHUNK)[None, :]
        use = on[:, None] & (sidx >= (delay + 1)[:, None]) & (sidx < n)
        y = jnp.where(use, yv, vx)
        ring = jnp.concatenate([ring[:, _LTP_CHUNK:], y], axis=1)
        return ring, y

    vchunks = vp.reshape(R, nchunks, _LTP_CHUNK).transpose(1, 0, 2)
    _, out = jax.lax.scan(step, jnp.zeros((R, _LTP_RING), jnp.int32),
                          (sbase, vchunks))
    out = out.transpose(1, 0, 2).reshape(R, nchunks * _LTP_CHUNK)[:, :n]
    return jnp.where(on[:, None], out, v)


@partial(jax.jit, static_argnames=("n", "B"))
def verify_blocks_device(out, expected, starts, okrows, *, n: int, B: int):
    """Compare decoded blocks against spans of a device-resident expected
    PCM (C, N) — decode to device-resident PCM, where only the verdict is
    fetched. Rows with okrows False (host-repaired) are skipped. Returns a
    device scalar bool."""
    C = expected.shape[0]
    gd = jax.lax.GatherDimensionNumbers(
        offset_dims=(1, 2), collapsed_slice_dims=(), start_index_map=(1,))
    sl = jax.lax.gather(expected,
                        jnp.clip(starts[:B, None], 0,
                                 expected.shape[1] - n), gd,
                        slice_sizes=(C, n), indices_are_sorted=False,
                        unique_indices=False)
    eq = out[:B] == sl
    return jnp.all(jnp.where(okrows[:B, None, None], eq, True))


@partial(jax.jit, static_argnames=("n", "C", "M", "has_ltp", "mesh"))
def decode_blocks_device2(words, start_bits, orders, rshifts, coefs,
                          ltp_orders, ltp_periods, ltp_coefs, pre_coef,
                          pre_prev, methods, lshift, *, n: int, C: int,
                          M: int, has_ltp: bool, mesh=None):
    """Fused device decode of one equal-size block group (word-machine).

    words: (B, W) uint32 big-endian payload words; start_bits: (B,) offset of
    the first channel's residual section (the parameter header is parsed on
    host — natively batched). Per-channel params (B, C[, .]) int32, coefs in
    emitted order (NOT reversed). Returns (pcm (B, C, n) int32 with stereo
    inverse and offset lshift applied, ovf (B,) bool — always False in the
    snapshot design, kept so the driver's host-repair plumbing stays wired
    for any future bounded-resource variant). mesh: the mesh the block axis
    is sharded over, if any (the synthesis kernel runs per shard).
    """
    B, W = words.shape
    sw = _shift_to_start(words, start_bits.astype(jnp.int32))
    snap, counts, azmask = _entropy_scan(sw.T, n, C)
    res = _assemble(snap, counts, azmask, n, C)          # (B, C, n)
    ovf = jnp.zeros((B,), bool)
    out = _synthesize(res, orders, rshifts, coefs, ltp_orders, ltp_periods,
                      ltp_coefs, pre_coef, pre_prev, methods, lshift,
                      n=n, C=C, M=M, has_ltp=has_ltp, mesh=mesh)
    return out, ovf
