"""Batched device decode (round 2): scan-based entropy unpack fused with
synthesis.

Entropy decode is serial per block (self-delimiting codewords), but blocks
are independent, so the block axis is the vector axis and ONE lax.scan step
decodes one codeword and synthesizes one sample for EVERY block at once
(SURVEY §5 'long-context' mapping; replaces the byte-serial reader of
libs/bit_stream/include/bit_stream.h:357-397).

The per-step trick that makes Rice unary runs O(1): precompute, for every
bit position p of every payload, NEXT_ONE[p] = the position of the first set
bit at or after p (a reverse cumulative minimum — one vectorized pass). A
codeword decode is then: one gather (the unary terminator), one 32-bit
window fetch (the tail), and integer ops — no data-dependent looping. The
fused step continues straight into the LPC recurrence, long-term (pitch)
prediction against a ring buffer, and de-emphasis, so a block group needs a
single device program and a single result fetch
(libs/srla_decoder/src/srla_decoder.c:436-676 collapsed into one scan).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (CODER_LOG2_MAX_NUM_PARTITIONS,
                         CODER_RICE_PARAMETER_BITS, LTP_COEFFICIENT_BITWIDTH,
                         CodeType)


@partial(jax.jit, static_argnames=("n", "max_order"))
def lpc_synthesize_batch(residual: jnp.ndarray, coefs: jnp.ndarray,
                         orders: jnp.ndarray, rshifts: jnp.ndarray,
                         *, n: int, max_order: int):
    """residual: (V, n) int32; coefs: (V, max_order) int32 reversed
    left-aligned; per-block orders/rshifts. Returns reconstructed (V, n).
    """
    V = residual.shape[0]
    M = max_order
    j = jnp.arange(M)[None, :]
    cols = j - (M - orders)[:, None]
    aligned = jnp.where(cols >= 0,
                        jnp.take_along_axis(coefs, jnp.clip(cols, 0, M - 1),
                                            axis=1), 0)
    half = jnp.where(rshifts > 0, jnp.int32(1) << jnp.maximum(rshifts - 1, 0),
                     jnp.int32(-2147483648))
    active = orders > 0

    def step(carry, x):
        window, s = carry            # window: (V, M) last M outputs
        acc = jnp.sum(window * aligned, axis=1) + half
        pred = acc >> rshifts
        prologue = x + window[:, -1]
        main = x - pred
        newval = jnp.where(s == 0, x,
                           jnp.where(s < orders, prologue, main))
        newval = jnp.where(active, newval, x)
        window = jnp.concatenate([window[:, 1:], newval[:, None]], axis=1)
        return (window, s + 1), newval

    init = (jnp.zeros((V, M), jnp.int32), jnp.int32(0))
    _, out = jax.lax.scan(step, init, residual.T)
    return out.T


@partial(jax.jit, static_argnames=("n",))
def deemphasis_batch(data: jnp.ndarray, coef: jnp.ndarray, prev: jnp.ndarray,
                     *, n: int):
    """y[i] = x[i] + ((y[i-1]*coef) >> 4), batched over blocks."""
    def step(y_prev, x):
        y = x + ((y_prev * coef) >> 4)
        return y, y

    _, out = jax.lax.scan(step, prev.astype(jnp.int32), data.T)
    return out.T


_LTP_RING = 512                     # > LTP_MAX_PERIOD + max half-order + 1
_LTP_RSHIFT = LTP_COEFFICIENT_BITWIDTH - 1
_MAX_LTP = 3                        # MAX_LTP_ORDER
# Scan unroll factor (1: the smallest compiled body).
_UNROLL = 1


def _next_one(words: jnp.ndarray) -> jnp.ndarray:
    """NEXT_ONE table: (B, W) uint32 big-endian words -> (B, W*32) int32 where
    entry p is the first set-bit position >= p (W*32 if none)."""
    B, W = words.shape
    sh = jnp.arange(31, -1, -1, dtype=jnp.uint32)
    bits = ((words[:, :, None] >> sh) & 1).astype(jnp.int32).reshape(B, -1)
    pos = jnp.arange(W * 32, dtype=jnp.int32)
    masked = jnp.where(bits == 1, pos, jnp.int32(W * 32))
    return jax.lax.cummin(masked, axis=1, reverse=True)


def _extract(wx: jnp.ndarray, pos: jnp.ndarray, nb: jnp.ndarray):
    """Read `nb` (0..32) bits at absolute bit offset `pos` per row.

    wx: (B, W+1) uint32 (one zero guard word); returns uint32."""
    w = pos >> 5
    b = (pos & 31).astype(jnp.uint32)
    w0 = jnp.take_along_axis(wx, w[:, None], axis=1)[:, 0]
    w1 = jnp.take_along_axis(wx, w[:, None] + 1, axis=1)[:, 0]
    rs = jnp.where(b == 0, jnp.uint32(1), 32 - b)      # avoid >>32
    comb = jnp.where(b == 0, w0, (w0 << b) | (w1 >> rs))
    nbu = nb.astype(jnp.uint32)
    return jnp.where(nb == 0, jnp.uint32(0),
                     comb >> jnp.where(nbu == 0, jnp.uint32(1), 32 - nbu))


def _unzigzag(u: jnp.ndarray) -> jnp.ndarray:
    ui = u.astype(jnp.int32)
    return (ui >> 1) ^ -(ui & 1)


@partial(jax.jit, static_argnames=("n", "C", "M"))
def decode_blocks_device(words, start_bits, orders, rshifts, coefs,
                         ltp_orders, ltp_periods, ltp_coefs, pre_coef,
                         pre_prev, methods, lshift, *, n: int, C: int,
                         M: int):
    """Fused device decode of one equal-size block group.

    words: (B, W) uint32 payload words; start_bits: (B,) bit offset of the
    channel-0 residual section. Per-channel params are (B, C[, .]) int32
    (coefs in emitted order, NOT reversed). Returns pcm (B, C, n) int32 with
    the stereo inverse and offset lshift already applied.

    Invalid porder/k fields from a corrupt-but-checksum-colliding stream
    yield garbage samples but never out-of-bounds access (all gathers are
    clipped) — the host caller has already checksum-verified each block.
    """
    B, W = words.shape
    NB = W * 32
    wx = jnp.concatenate([words, jnp.zeros((B, 1), jnp.uint32)], axis=1)
    no = _next_one(words)

    def gather_no(pos):
        return jnp.take_along_axis(
            no, jnp.clip(pos, 0, NB - 1)[:, None], axis=1)[:, 0]

    pos = start_bits.astype(jnp.int32)
    chans = []
    for c in range(C):
        ctype = _extract(wx, pos, jnp.full((B,), 2, jnp.int32)).astype(
            jnp.int32)
        pos = pos + 2
        az = ctype == CodeType.ALLZERO
        recursive = ctype == CodeType.RECURSIVE_RICE
        porder = jnp.where(
            az, 0,
            _extract(wx, pos,
                     jnp.full((B,), CODER_LOG2_MAX_NUM_PARTITIONS,
                              jnp.int32)).astype(jnp.int32))
        pos = pos + jnp.where(az, 0, CODER_LOG2_MAX_NUM_PARTITIONS)
        nsmpl = jnp.maximum(jnp.int32(n) >> jnp.clip(porder, 0, 31), 1)
        k = jnp.where(
            az, 0,
            _extract(wx, pos,
                     jnp.full((B,), CODER_RICE_PARAMETER_BITS,
                              jnp.int32)).astype(jnp.int32))
        pos = pos + jnp.where(az, 0, CODER_RICE_PARAMETER_BITS)

        # Channel-c synthesis parameters, aligned for the window dot.
        ordc = orders[:, c]
        j = jnp.arange(M)[None, :]
        cols = j - (M - ordc)[:, None]
        aligned = jnp.where(
            cols >= 0,
            jnp.take_along_axis(coefs[:, c], jnp.clip(cols, 0, M - 1),
                                axis=1), 0)
        rsh = rshifts[:, c]
        half = jnp.where(rsh > 0, jnp.int32(1) << jnp.maximum(rsh - 1, 0),
                         jnp.int32(-2147483648))
        lpc_on = ordc > 0
        lorder = ltp_orders[:, c]
        lper = ltp_periods[:, c]
        ltp_on = (lper > 0) & (lorder > 0)
        delay = lper + (lorder >> 1)
        lcoef = ltp_coefs[:, c]                       # (B, >=_MAX_LTP)
        dcoef = pre_coef[:, c]
        dprev = pre_prev[:, c].astype(jnp.int32)

        def step(carry, s):
            pos, k, win, ring, yprev = carry
            # Partition-boundary parameter codeword (unary zigzag delta).
            is_p = (~az) & (s > 0) & (jnp.remainder(s, nsmpl) == 0)
            t = gather_no(pos)
            k_p = jnp.clip(k + _unzigzag((t - pos).astype(jnp.uint32)),
                           0, 31)
            k = jnp.where(is_p, k_p, k)
            pos = jnp.where(is_p, t + 1, pos)
            # Sample codeword.
            t = gather_no(pos)
            q = t - pos
            ku = k.astype(jnp.uint32)
            # Plain Rice: q zeros, 1, k-bit remainder.
            rem_r = _extract(wx, t + 1, k)
            u_r = (q.astype(jnp.uint32) << ku) | rem_r
            np_r = t + 1 + k
            # Recursive Rice: q==0 -> 1, (k+1)-bit value; else
            # u = 2^(k+1) + (q-1)*2^k + k-bit remainder.
            k1 = k + 1
            u_small = _extract(wx, t + 1, k1)
            u_big = ((jnp.uint32(1) << (ku + 1))
                     + ((q - 1).astype(jnp.uint32) << ku)) | rem_r
            smallc = q == 0
            u_rr = jnp.where(smallc, u_small, u_big)
            np_rr = jnp.where(smallc, t + 1 + k1, t + 1 + k)
            u = jnp.where(recursive, u_rr, u_r)
            newpos = jnp.where(recursive, np_rr, np_r)
            u = jnp.where(az, 0, u)
            pos = jnp.where(az, pos, newpos)
            r = _unzigzag(u)
            # LPC recurrence (int32 wrap == the host's int64-then-truncate).
            acc = jnp.sum(win * aligned, axis=1) + half
            pred = acc >> rsh
            nv = jnp.where(s == 0, r,
                           jnp.where(s < ordc, r + win[:, -1], r - pred))
            nv = jnp.where(lpc_on, nv, r)
            win = jnp.concatenate([win[:, 1:], nv[:, None]], axis=1)
            # Long-term prediction against the ring of this channel's output.
            lacc = jnp.full((B,), jnp.int32(1 << (_LTP_RSHIFT - 1)))
            base = s - delay
            for i in range(_MAX_LTP):
                g = jnp.take_along_axis(
                    ring, ((base + i) & (_LTP_RING - 1))[:, None],
                    axis=1)[:, 0]
                lacc = lacc + jnp.where(i < lorder, lcoef[:, i] * g, 0)
            yv = jnp.where(ltp_on & (s >= delay + 1),
                           nv + (lacc >> _LTP_RSHIFT), nv)
            ring = jax.lax.dynamic_update_slice(
                ring, yv[:, None], (jnp.int32(0), s & (_LTP_RING - 1)))
            # De-emphasis.
            y = yv + ((yprev * dcoef) >> 4)
            return (pos, k, win, ring, y), y

        init = (pos, k, jnp.zeros((B, M), jnp.int32),
                jnp.zeros((B, _LTP_RING), jnp.int32), dprev)
        (pos, k, _, _, _), ys = jax.lax.scan(
            step, init, jnp.arange(n, dtype=jnp.int32),
            unroll=min(_UNROLL, n))
        chans.append(ys.T)                             # (B, n)

    out = jnp.stack(chans, axis=1)                     # (B, C, n)
    if C >= 2:
        m = methods[:, None]
        c0, c1 = out[:, 0], out[:, 1]
        c0_ms = c0 - (c1 >> 1)
        c0 = jnp.where(m == 1, c0_ms, c0)
        c1 = jnp.where(m == 1, c1 + c0_ms, c1)
        c1 = jnp.where(m == 2, out[:, 1] + out[:, 0], c1)
        c0 = jnp.where(m == 3, out[:, 1] - out[:, 0], c0)
        out = jnp.concatenate([c0[:, None], c1[:, None], out[:, 2:]], axis=1)
    out = out << lshift
    return out


def synthesize_blocks(residuals: np.ndarray, coefs: np.ndarray,
                      orders: np.ndarray, rshifts: np.ndarray,
                      pre_coef: np.ndarray, pre_prev: np.ndarray,
                      n: int) -> np.ndarray:
    """Full batched synthesis for LTP-free blocks (JAX device path)."""
    M = max(int(orders.max()), 1) if orders.size else 1
    out = lpc_synthesize_batch(
        jnp.asarray(residuals), jnp.asarray(coefs[:, :M]),
        jnp.asarray(orders), jnp.asarray(rshifts), n=n, max_order=M)
    out = deemphasis_batch(out, jnp.asarray(pre_coef),
                           jnp.asarray(pre_prev), n=n)
    return np.asarray(out)
