"""Bit-exact device encode analysis (df64 double-float + boundary flagging).

The f32 fast path (kernels/encode.py) admits parameter choices that differ
from the exact f64 host pipeline. This module re-derives the SAME decisions on
device using double-float (two-f32) arithmetic (kernels/df64.py, ~2^-48
relative accuracy) and, for every discrete decision the float analysis feeds
(pre-emphasis coefficient rounding, LPC order argmin, coefficient
quantization rounding + frexp shift, Rice parameter boundaries, recursive/
plain selection, silent thresholds), computes the distance to the nearest
decision boundary. A variant whose distance anywhere falls below a safety
margin — chosen orders of magnitude above the df64-vs-f64 discrepancy bound,
scaled by a per-variant conditioning estimate — is flagged `risky`; the
encoder re-derives flagged blocks on the exact host path. Unflagged variants
provably make the same decisions as the host oracle, so the emitted stream is
byte-identical to the reference and deterministic.

All downstream residual/bit math is exact wrapping-int32 (shared with
kernels/encode.py). Decision parity targets (reference):
libs/lpc/src/lpc.c:330-441 (autocorr+Levinson), :535-570, :1341-1405
(quantize), libs/srla_coder/src/srla_coder.c:262-324 (Rice parameters),
libs/srla_internal/src/srla_utility.c:206-257 (pre-emphasis).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (CODER_LOG2_MAX_NUM_PARTITIONS,
                         LPC_COEFFICIENT_BITWIDTH,
                         LPC_COEFFICIENT_ORDER_BITWIDTH,
                         LPC_RIDGE_REGULARIZATION_PARAMETER,
                         LTP_COEFFICIENT_BITWIDTH, LTP_ORDER_BITWIDTH,
                         LTP_PERIOD_BITWIDTH, PREEMPHASIS_COEF_SHIFT,
                         RSHIFT_LPC_COEFFICIENT_BITWIDTH)
from ..dsp.window import welch_inverse_squared_sum, welch_window
from ..rice import MLNOPTX, OPTX, _INV_LOGE2, _LOG_OPTX
from . import df64 as dd
from .encode import _predict, _reverse_coefs, _zigzag

FLT_EPSILON = 1.1920928955078125e-07

# Safety margins. df64-vs-f64 discrepancies are ~2^-44 relative (amplified by
# the conditioning factor kappa where noted); margins sit >=100x above that
# and ~10x above the host's own vectorized-libm tie-repair thresholds, so an
# unflagged decision is the same in both pipelines.
_EPS_PREEMPH = 1e-8          # |16*r1/r0| distance to rounding half-boundary
_EPS_RICE_LOG = 1e-8         # |log2v| distance to round-half boundary
_EPS_RICE_TRUNC = 1e-9       # relative distance to k2 truncation boundary
_EPS_RICE_MEAN2 = 1e-9       # |mean - 2| recursive/plain selection
_EPS_SILENT = 1e-6           # relative |r0| distance to FLT_EPSILON
_EPS_ORDER_BASE = 1e-6       # bits; matches the host tie-repair trigger
_EPS_QUANT_BASE = 1e-7       # quantized-units distance to rounding boundary
_KAPPA_SCALE = np.float32(2.0 ** -40)  # conditioning amplification allowance


def _dd_const(v):
    return dd.const(float(v))


def _dist_to_half(x):
    """Distance of df value x to the nearest (k + 0.5) rounding boundary of
    round-half-away-from-zero, evaluated on |x| (boundaries are symmetric)."""
    ax = dd.abs_(x)
    fr = dd.sub(ax, dd.floor(ax))
    return jnp.abs(dd.to_f32(fr) - np.float32(0.5))


def _dist_to_int(x):
    """Distance of df value x to the nearest integer (truncation boundary)."""
    fr = dd.sub(x, dd.floor(x))
    f = dd.to_f32(fr)
    return jnp.minimum(f, 1.0 - f)


# ---------------------------------------------------------------------------
# Pre-emphasis (exact decision + exact int32 filter)
# ---------------------------------------------------------------------------

def _preemphasis_exact(sig: jnp.ndarray):
    """sig: (V, n) int32. Returns (work int32, coef int32, risky bool)."""
    x = dd.from_int32(sig)
    r0 = dd.sum_pairwise(dd.mul(x, x), axis=1)
    x0 = (x[0][:, :-1], x[1][:, :-1])
    x1 = (x[0][:, 1:], x[1][:, 1:])
    r1 = dd.sum_pairwise(dd.mul(x0, x1), axis=1)
    zero = (r0[0] == 0) & (r0[1] == 0)
    safe_r0 = (jnp.where(zero, 1.0, r0[0]), jnp.where(zero, 0.0, r0[1]))
    dc16 = dd.mul_pow2(dd.div(r1, safe_r0), float(1 << PREEMPHASIS_COEF_SHIFT))
    q = dd.to_f32(dd.round_half_away(dc16))
    coef = jnp.clip(q, -(1 << PREEMPHASIS_COEF_SHIFT),
                    (1 << PREEMPHASIS_COEF_SHIFT) - 1).astype(jnp.int32)
    coef = jnp.where(zero, 0, coef)
    risky = (_dist_to_half(dc16) < _EPS_PREEMPH) & ~zero
    prev = jnp.concatenate([sig[:, :1], sig[:, :-1]], axis=1)
    pred = (prev * coef[:, None]) >> PREEMPHASIS_COEF_SHIFT
    return sig - pred, coef, risky


# ---------------------------------------------------------------------------
# Windowed circular autocorrelation (df64 direct-lag; value-accurate, the
# reference's FFT path is only ever consumed through flagged decisions)
# ---------------------------------------------------------------------------

def _autocorr_dd(work: jnp.ndarray, n: int, bps: int, order: int,
                 fft_size: int):
    """work: (V, n) int32. Returns df (V, order) matching the host
    autocorr_fft value (circular over the zero-padded pow2 buffer, scaled by
    fft_size/n) to ~2^-44 relative accuracy. Odd n: the Welch window's
    unwritten middle sample is taken as 0 (the stale-state-free case; the
    encoder routes stale-state-dependent blocks to the host)."""
    win = welch_window(n).copy()
    if n & 1:
        win[n // 2] = 0.0
    wn_hi, wn_lo = dd.split_f64(win * 2.0 ** (-(bps - 1)))
    d = dd.mul(dd.from_int32(work), (jnp.asarray(wn_hi)[None, :],
                                     jnp.asarray(wn_lo)[None, :]))
    V = work.shape[0]
    F = fft_size
    pad = F - n
    dh = jnp.pad(d[0], ((0, 0), (0, pad)))
    dl = jnp.pad(d[1], ((0, 0), (0, pad)))
    d2h = jnp.concatenate([dh, dh], axis=1)
    d2l = jnp.concatenate([dl, dl], axis=1)
    norm = dd.const(float(F) / float(n))

    def body(k, ac):
        rh = jax.lax.dynamic_slice_in_dim(d2h, k, F, axis=1)
        rl = jax.lax.dynamic_slice_in_dim(d2l, k, F, axis=1)
        s = dd.sum_pairwise(dd.mul((dh, dl), (rh, rl)), axis=1)
        s = dd.mul(s, norm)
        ach = jax.lax.dynamic_update_slice_in_dim(ac[0], s[0][:, None], k,
                                                  axis=1)
        acl = jax.lax.dynamic_update_slice_in_dim(ac[1], s[1][:, None], k,
                                                  axis=1)
        return (ach, acl)

    ac0 = (jnp.zeros((V, order), jnp.float32), jnp.zeros((V, order),
                                                         jnp.float32))
    return jax.lax.fori_loop(0, order, body, ac0)


# ---------------------------------------------------------------------------
# Levinson-Durbin in df64 (structure mirrors kernels/encode.py:_levinson)
# ---------------------------------------------------------------------------

def _levinson_dd(ac, max_order: int, orders=None):
    """ac: df (V, M+1) (ridge already applied to lag 0). Returns
    (error_vars df (V, M+1), coefs df (V, M) at per-variant `orders` or None,
    silent bool (V,), risky bool (V,))."""
    V = ac[0].shape[0]
    M = max_order
    r0 = (ac[0][:, 0], ac[1][:, 0])
    zero_r0 = (r0[0] == 0) & (r0[1] == 0)
    sr0 = (jnp.where(zero_r0, 1.0, r0[0]), jnp.where(zero_r0, 0.0, r0[1]))

    def zeros(shape):
        return (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))

    def put(x, col, val):
        return (x[0].at[:, col].set(val[0]), x[1].at[:, col].set(val[1]))

    def col(x, c):
        return (x[0][:, c], x[1][:, c])

    a = zeros((V, M + 2))
    a = put(a, 0, (jnp.ones(V, jnp.float32), jnp.zeros(V, jnp.float32)))
    ac1 = col(ac, 1)
    a1 = dd.div(dd.neg(ac1), sr0)
    a = put(a, 1, a1)
    ev = zeros((V, M + 1))
    ev = put(ev, 0, r0)
    ev1 = dd.add(r0, dd.mul(ac1, a1))
    ev = put(ev, 1, ev1)
    collect = orders is not None
    collected = zeros((V, M))
    if collect:
        sel = (orders == 1)[:, None]
        first_h = jnp.pad(a1[0][:, None], ((0, 0), (0, M - 1)))
        first_l = jnp.pad(a1[1][:, None], ((0, 0), (0, M - 1)))
        collected = (jnp.where(sel, first_h, collected[0]),
                     jnp.where(sel, first_l, collected[1]))

    # acflip_pad[j] = ac[M+1-j] for j <= M+1, 0 beyond (per plane).
    def flip_pad(x, width):
        xe = jnp.pad(x, ((0, 0), (0, 1)))
        return jnp.pad(xe[:, ::-1], ((0, 0), (0, width)))

    acf = (flip_pad(ac[0], M + 2), flip_pad(ac[1], M + 2))
    aidx = jnp.arange(M + 2)

    def body(k, carry):
        a, ev, collected = carry
        winh = jax.lax.dynamic_slice_in_dim(acf[0], M - k - 1, M + 2, axis=1)
        winl = jax.lax.dynamic_slice_in_dim(acf[1], M - k - 1, M + 2, axis=1)
        gamma = dd.sum_pairwise(dd.mul(a, (winh, winl)), axis=1)
        evkh = jax.lax.dynamic_slice_in_dim(ev[0], k + 1, 1, axis=1)[:, 0]
        evkl = jax.lax.dynamic_slice_in_dim(ev[1], k + 1, 1, axis=1)[:, 0]
        zero_ev = (evkh == 0) & (evkl == 0)
        sev = (jnp.where(zero_ev, 1.0, evkh), jnp.where(zero_ev, 0.0, evkl))
        gamma = dd.div(gamma, dd.neg(sev))
        one = dd.one_like(gamma[0])
        ev_next = dd.mul((evkh, evkl), dd.sub(one, dd.mul(gamma, gamma)))
        ev = (jax.lax.dynamic_update_slice_in_dim(
                  ev[0], ev_next[0][:, None], k + 2, axis=1),
              jax.lax.dynamic_update_slice_in_dim(
                  ev[1], ev_next[1][:, None], k + 2, axis=1))
        arevh = jax.lax.dynamic_slice_in_dim(
            jnp.pad(a[0][:, ::-1], ((0, 0), (0, M + 2))), M - k - 1, M + 2,
            axis=1)
        arevl = jax.lax.dynamic_slice_in_dim(
            jnp.pad(a[1][:, ::-1], ((0, 0), (0, M + 2))), M - k - 1, M + 2,
            axis=1)
        a_new = dd.add(a, dd.mul((gamma[0][:, None], gamma[1][:, None]),
                                 (arevh, arevl)))
        live = (aidx <= k + 2)[None, :]
        a_new = (jnp.where(live, a_new[0], 0.0), jnp.where(live, a_new[1],
                                                           0.0))
        if collect:
            sel = (orders == (k + 2))[:, None]
            collected = (jnp.where(sel, a_new[0][:, 1:M + 1], collected[0]),
                         jnp.where(sel, a_new[1][:, 1:M + 1], collected[1]))
        return (a_new, ev, collected)

    if M > 1:
        a, ev, collected = jax.lax.fori_loop(0, M - 1, body,
                                             (a, ev, collected))

    absr0 = dd.to_f32(dd.abs_(r0))
    silent = absr0 < np.float32(FLT_EPSILON)
    risky = jnp.abs(absr0 - np.float32(FLT_EPSILON)) < \
        np.float32(_EPS_SILENT * FLT_EPSILON)
    evs = (jnp.where(silent[:, None], r0[0][:, None], ev[0]),
           jnp.where(silent[:, None], r0[1][:, None], ev[1]))
    if collect:
        collected = (jnp.where(silent[:, None], 0.0, collected[0]),
                     jnp.where(silent[:, None], 0.0, collected[1]))
    # Conditioning estimate: r0 / min |ev| over the recursion (ev decreasing
    # in exact arithmetic, but guard with an explicit min).
    ev_abs = jnp.abs(evs[0]) + jnp.abs(evs[1])
    min_ev = jnp.min(jnp.where(ev_abs > 0, ev_abs, jnp.inf), axis=1)
    kappa = jnp.where(silent, 1.0,
                      jnp.abs(r0[0]) / jnp.where(jnp.isfinite(min_ev)
                                                 & (min_ev > 0), min_ev, 1.0))
    kappa = jnp.where(jnp.isfinite(kappa) & (kappa >= 1.0), kappa, jnp.inf)
    nonfinite = ~(jnp.isfinite(evs[0]).all(axis=1))
    if collect:
        nonfinite = nonfinite | ~(jnp.isfinite(collected[0]).all(axis=1))
    risky = risky | (nonfinite & ~silent)
    return evs, (collected if collect else None), silent, risky, kappa


# ---------------------------------------------------------------------------
# Order selection (BRUTEFORCE_ESTIMATION) in df64
# ---------------------------------------------------------------------------

def _select_order_exact(ev, n: int, bps: int, max_params: int,
                        max_fixed: bool, kappa):
    """ev: df (V, M+1) error variances (window-energy-corrected). Returns
    (orders (V,), risky (V,)). The whole entropy chain is evaluated batched
    over (V, M) — one dd transcendental chain, not one per order — and the
    argmin runs as a fori_loop (first strict minimum wins, like np.argmin)."""
    V = ev[0].shape[0]
    if max_fixed:
        return jnp.full((V,), max_params, jnp.int32), jnp.zeros(V, bool)
    M = max_params
    one = _dd_const(1.0)
    inv_loge2 = _dd_const(_INV_LOGE2)
    nf = _dd_const(float(n))
    evo = (ev[0][:, 1:M + 1], ev[1][:, 1:M + 1])
    neg_ev = evo[0] < 0
    sev = (jnp.where(neg_ev, 0.0, evo[0]), jnp.where(neg_ev, 0.0, evo[1]))
    mabse = dd.mul_pow2(dd.sqrt(dd.mul_pow2(sev, 0.5)), 2.0)
    intmean = dd.mul_pow2(mabse, float(1 << (bps - 1)))
    rho = dd.div(one, dd.add(one, intmean))
    invrho = dd.sub(one, rho)
    # Guard logs at 0 (mabse == 0 -> ent forced to 0 below).
    z = mabse[0] < np.float32(1e-16)
    g_invrho = (jnp.where(invrho[0] <= 0, 0.5, invrho[0]),
                jnp.where(invrho[0] <= 0, 0.0, invrho[1]))
    g_rho = (jnp.where(rho[0] <= 0, 0.5, rho[0]),
             jnp.where(rho[0] <= 0, 0.0, rho[1]))
    t1 = dd.mul(invrho, dd.mul(dd.log(g_invrho), inv_loge2))
    t2 = dd.mul(rho, dd.mul(dd.log(g_rho), inv_loge2))
    ent = dd.div(dd.neg(dd.add(t1, t2)), rho)
    ent = (jnp.where(z, 0.0, ent[0]), jnp.where(z, 0.0, ent[1]))
    coef_bits = (LPC_COEFFICIENT_BITWIDTH
                 * jnp.arange(1, M + 1, dtype=jnp.float32))[None, :]
    length = dd.add(dd.mul(ent, nf),
                    (dd._pin(coef_bits), dd._pin(jnp.zeros_like(coef_bits))))
    risky = jnp.any(~neg_ev & (jnp.abs(mabse[0] - np.float32(1e-16))
                               < np.float32(1e-17)), axis=1)
    bad = neg_ev | ~jnp.isfinite(length[0])
    lh = jnp.where(bad, np.float32(np.inf), length[0])
    ll = jnp.where(bad, 0.0, length[1])

    def body(i, carry):
        best, second, orders = carry
        cand = (lh[:, i], ll[:, i])
        better = dd.lt(cand, best)
        second = (jnp.where(better, best[0], second[0]),
                  jnp.where(better, best[1], second[1]))
        closer2 = ~better & dd.lt(cand, second)
        second = (jnp.where(closer2, cand[0], second[0]),
                  jnp.where(closer2, cand[1], second[1]))
        best = (jnp.where(better, cand[0], best[0]),
                jnp.where(better, cand[1], best[1]))
        orders = jnp.where(better, i + 1, orders)
        return (best, second, orders)

    init = ((jnp.full(V, np.float32(np.inf)), jnp.zeros(V, jnp.float32)),
            (jnp.full(V, np.float32(np.inf)), jnp.zeros(V, jnp.float32)),
            jnp.ones(V, jnp.int32))
    best, second, orders = jax.lax.fori_loop(0, M, body, init)
    gap = dd.to_f32(dd.sub(second, best))
    eps = jnp.maximum(np.float32(_EPS_ORDER_BASE),
                      np.float32(n) * kappa.astype(jnp.float32) *
                      _KAPPA_SCALE)
    risky = risky | ~jnp.isfinite(best[0]) | (jnp.isfinite(gap) & (gap < eps))
    return orders, risky


# ---------------------------------------------------------------------------
# Coefficient quantization in df64
# ---------------------------------------------------------------------------

def _quantize_exact(coefs, orders, nbits: int, max_bits: int, kappa):
    """coefs: df (V, M) left-aligned. Returns (int_coefs (V, M) int32,
    rshift (V,) int32, risky (V,))."""
    V, M = coefs[0].shape
    qmax = 1 << (nbits - 1)
    mask = jnp.arange(M)[None, :] < orders[:, None]
    ac = dd.abs_(coefs)
    ach = jnp.where(mask, ac[0], 0.0)
    acl = jnp.where(mask, ac[1], 0.0)
    # Pairwise lexicographic max.
    n = 1
    while n < max(M, 1):
        n *= 2
    if n != M:
        ach = jnp.pad(ach, ((0, 0), (0, n - M)))
        acl = jnp.pad(acl, ((0, 0), (0, n - M)))
    while n > 1:
        n //= 2
        l = (ach[:, :n], acl[:, :n])
        r = (ach[:, n:], acl[:, n:])
        take_l = dd.ge(l, r)
        ach = jnp.where(take_l, l[0], r[0])
        acl = jnp.where(take_l, l[1], r[1])
    maxabs = (ach[:, 0], acl[:, 0])

    eps_k = jnp.maximum(np.float32(_EPS_QUANT_BASE),
                        np.float32(2 * qmax) * kappa.astype(jnp.float32)
                        * _KAPPA_SCALE)
    tiny_thresh = np.float32(2.0 ** (-(nbits - 1)))
    tiny = maxabs[0] + maxabs[1] <= tiny_thresh
    risky = jnp.abs((maxabs[0] - tiny_thresh) + maxabs[1]) \
        < tiny_thresh * np.float32(1e-6)
    # frexp boundary: maxabs close to a power of two flips ndigit.
    safe_hi = jnp.maximum(maxabs[0], np.float32(1e-38))
    m_hi, e_hi = jnp.frexp(safe_hi)
    scale_back = jnp.exp2(-e_hi.astype(jnp.float32))
    m_full = m_hi + maxabs[1] * scale_back
    risky = risky | (~tiny & ((jnp.abs(m_full - 0.5) < np.float32(1e-7))
                              | (m_full > np.float32(1.0 - 1e-7))))
    ndigit = e_hi - (m_full < 0.5).astype(e_hi.dtype)
    ndigit = jnp.where(maxabs[0] == 0, 0, ndigit)
    rshift = (nbits - 1) - ndigit
    rshift = jnp.where((rshift >= max_bits) | (rshift < 0), max_bits - 1,
                       rshift)
    rshift = jnp.where(tiny, nbits, rshift).astype(jnp.int32)
    scale = jnp.exp2(rshift.astype(jnp.float32))  # exact power of two

    def body(i, carry):
        qerr, intc, risky = carry
        ordi = M - 1 - i
        active = orders > ordi
        c = (coefs[0][:, ordi] * scale, coefs[1][:, ordi] * scale)
        qe = dd.add(qerr, c)
        qt = dd.to_f32(dd.round_half_away(qe))
        qt = jnp.clip(qt, -qmax, qmax - 1)
        risky = risky | (active & (_dist_to_half(qe) < eps_k))
        new_err = dd.sub(qe, (qt, jnp.zeros_like(qt)))
        qerr = (jnp.where(active, new_err[0], qerr[0]),
                jnp.where(active, new_err[1], qerr[1]))
        intc = intc.at[:, ordi].set(jnp.where(active, qt.astype(jnp.int32),
                                              0))
        return (qerr, intc, risky)

    zero = (jnp.zeros(V, jnp.float32), jnp.zeros(V, jnp.float32))
    _, intc, risky = jax.lax.fori_loop(
        0, M, body, (zero, jnp.zeros((V, M), jnp.int32), risky))
    intc = jnp.where(tiny[:, None], 0, intc)
    risky = risky | ~jnp.isfinite(maxabs[0])
    return intc, rshift, risky


# ---------------------------------------------------------------------------
# Partitioned Rice parameter search in df64 (mirrors rice.analyze_batch)
# ---------------------------------------------------------------------------

_RICE_BOUNDARIES = None


def _rice_k_boundaries():
    """Host-precomputed (f64) decision boundaries of the two Rice-parameter
    chains, expressed in PARTITION-MEAN space, as (hi, lo, eps) f32 tables of
    33 entries (index j holds boundary j for j=1..31; 0/32 are sentinels).

    Plain Rice (srla_coder.c:262-287): k = max(0, round(log2v)) with
    log2v = log2(ln OPTX / ln(1 - 1/(1+m))) — boundary j at log2v = j - 0.5.
    Recursive (c:298-324): k2 = log2floor(trunc(MLNOPTX*(1+m))) — boundary j
    at MLNOPTX*(1+m) = 2^j. Both are strictly increasing in m. eps bands
    cover the host f64 chain's rounding, its 1e-9 scalar-libm tie-repair
    trigger, and the device's dd representation error, with wide margin.
    """
    global _RICE_BOUNDARIES
    if _RICE_BOUNDARIES is not None:
        return _RICE_BOUNDARIES
    import math

    def m_of_log2v(l2v):
        v = 2.0 ** l2v
        om = math.exp(_LOG_OPTX / v)
        return om / (1.0 - om)

    BIG = 3.0e38
    kb = [-BIG]
    kb_eps = [0.0]
    tb = [-BIG]
    tb_eps = [0.0]
    for j in range(1, 32):
        m = m_of_log2v(j - 0.5)
        dm = abs(m_of_log2v(j - 0.5 + 1e-8) - m)
        kb.append(m)
        kb_eps.append(dm + m * 2.0 ** -40 + 1e-12)
        t = 2.0 ** j / MLNOPTX - 1.0
        tb.append(t)
        tb_eps.append(max(1e-9, t * 2.0 ** -38))
    kb.append(BIG)
    kb_eps.append(0.0)
    tb.append(BIG)
    tb_eps.append(0.0)
    kb_hi, kb_lo = dd.split_f64(np.asarray(kb))
    tb_hi, tb_lo = dd.split_f64(np.asarray(tb))
    _RICE_BOUNDARIES = ((kb_hi, kb_lo, np.asarray(kb_eps, np.float32)),
                        (tb_hi, tb_lo, np.asarray(tb_eps, np.float32)))
    return _RICE_BOUNDARIES


def _rice_exact(residual: jnp.ndarray, n: int, max_porder: int):
    """residual: (V, n) int32. Returns (code_type, porder, bits(+2), ks
    (V, 1 << max_porder) int32, risky)."""
    V = residual.shape[0]
    u = _zigzag(residual)
    ui = u.astype(jnp.int32)  # values < 2^31 for <=24-bit content
    max_uval = jnp.max(u, axis=1)

    # Per-level partition means (df64; leaf sums are exact integers).
    nleaf = 1 << max_porder
    nsmpl_leaf = n >> max_porder
    leaf = dd.from_int32(ui.reshape(V, nleaf, nsmpl_leaf))
    leaf_sum = dd.sum_pairwise(leaf, axis=2)
    means = [None] * (max_porder + 1)
    means[max_porder] = dd.div(leaf_sum, _dd_const(float(nsmpl_leaf)))
    for p in range(max_porder - 1, -1, -1):
        m = means[p + 1]
        means[p] = dd.mul_pow2(dd.add((m[0][:, 0::2], m[1][:, 0::2]),
                                      (m[0][:, 1::2], m[1][:, 1::2])), 0.5)

    mean_all = (means[0][0][:, 0], means[0][1][:, 0])
    two = _dd_const(2.0)
    recursive = dd.ge(mean_all, two)
    risky = jnp.abs(dd.to_f32(dd.sub(mean_all, two))) \
        < np.float32(_EPS_RICE_MEAN2)

    # Both Rice-parameter decisions are MONOTONE in the partition mean, so
    # instead of evaluating the reference's transcendental chains per
    # partition (two dd logs + divs over up-to-2047 partitions x V — the
    # dominant analysis cost), compare the dd mean against HOST-precomputed
    # f64 decision boundaries in mean-space. Flag any mean that lands within
    # the boundary's uncertainty band (host f64 chain rounding + its 1e-9
    # vectorized-libm tie-repair region + dd error, with ~30x safety).
    flat = (jnp.concatenate([means[p][0] for p in range(max_porder + 1)],
                            axis=1),
            jnp.concatenate([means[p][1] for p in range(max_porder + 1)],
                            axis=1))
    zero_mean_f = (flat[0] == 0) & (flat[1] == 0)
    (kb_hi, kb_lo, kb_eps), (tb_hi, tb_lo, tb_eps) = _rice_k_boundaries()

    def count_and_flag(b_hi, b_lo, b_eps):
        k = jnp.zeros(flat[0].shape, jnp.int32)
        for j in range(1, 32):
            bj = (jnp.float32(b_hi[j]), jnp.float32(b_lo[j]))
            k = k + dd.ge(flat, bj).astype(jnp.int32)
        # Distance to the two adjacent boundaries (sentinel-padded tables).
        bh = jnp.asarray(b_hi)[k]
        bl = jnp.asarray(b_lo)[k]
        be = jnp.asarray(b_eps)[k]
        bh2 = jnp.asarray(b_hi)[k + 1]
        bl2 = jnp.asarray(b_lo)[k + 1]
        be2 = jnp.asarray(b_eps)[k + 1]
        d1 = jnp.abs(dd.to_f32(dd.sub(flat, (bh, bl))))
        d2 = jnp.abs(dd.to_f32(dd.sub((bh2, bl2), flat)))
        flagged = ((d1 < be) | (d2 < be2) | (k >= 31)) & ~zero_mean_f
        return k, flagged

    # Plain Rice: k = max(0, round(log2(ln OPTX / ln(1 - 1/(1+m))))).
    kr_f, r_log_f = count_and_flag(kb_hi, kb_lo, kb_eps)
    # Recursive Rice: k2 = log2floor(max(1, trunc(MLNOPTX * (1+m)))).
    k2_f, r_trunc_f = count_and_flag(tb_hi, tb_lo, tb_eps)

    best_bits = jnp.full(V, jnp.int32(2 ** 30))
    best_porder = jnp.zeros(V, jnp.int32)
    MAXP = 1 << max_porder
    best_ks = jnp.zeros((V, MAXP), jnp.int32)

    off = 0
    for porder in range(max_porder + 1):
        nparts = 1 << porder
        nsmpl = n >> porder
        up = ui.reshape(V, nparts, nsmpl)
        k2 = k2_f[:, off:off + nparts]
        kr = kr_f[:, off:off + nparts]
        r_trunc = r_trunc_f[:, off:off + nparts]
        r_log = r_log_f[:, off:off + nparts]
        off += nparts
        k1pow = jnp.int32(1) << (k2 + 1)
        dver = up - k1pow[:, :, None]
        rec_bits = (jnp.sum(jnp.maximum(dver, 0) >> k2[:, :, None], axis=2)
                    + (k2 + 2) * nsmpl)
        rice_bits = (jnp.sum(up >> kr[:, :, None], axis=2)
                     + (kr + 1) * nsmpl).astype(jnp.int32)

        ks = jnp.where(recursive[:, None], k2, kr)
        part_bits = jnp.where(recursive[:, None], rec_bits, rice_bits)
        pflag = jnp.where(recursive[:, None], r_trunc, r_log)
        risky = risky | jnp.any(pflag, axis=1)
        deltas = _zigzag(ks[:, 1:] - ks[:, :-1]).astype(jnp.int32)
        bits = (CODER_LOG2_MAX_NUM_PARTITIONS + 5
                + jnp.sum(part_bits, axis=1)
                + jnp.sum(deltas + 1, axis=1)).astype(jnp.int32)
        better = bits < best_bits
        best_bits = jnp.where(better, bits, best_bits)
        best_porder = jnp.where(better, porder, best_porder)
        ks_pad = jnp.pad(ks, ((0, 0), (0, MAXP - nparts)))
        best_ks = jnp.where(better[:, None], ks_pad, best_ks)

    allzero = max_uval == 0
    code_type = jnp.where(allzero, 2,
                          jnp.where(recursive, 1, 0)).astype(jnp.int32)
    bits = jnp.where(allzero, 0, best_bits) + 2
    best_porder = jnp.where(allzero, 0, best_porder)
    risky = risky & ~allzero
    return code_type, best_porder, bits, best_ks, risky


# ---------------------------------------------------------------------------
# Full per-variant pipeline
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# SVR coefficient refinement in df64 (parity: lpc.c:988-1163 via dsp/svr.py)
# ---------------------------------------------------------------------------
# Per margin in the preset list: residual filter -> soft threshold -> solve
# a coefficient delta against the cached Cholesky factorization of the
# (ridged) signal covariance; keep the coefficients minimizing the estimated
# recursive-Rice code length. All sums are value-continuous (df64 pairwise
# vs the host's sequential f64 is within ~2^-44 relative); the DISCRETE
# outcomes — the two objective comparisons per iteration, the 1e-8
# convergence epsilon, the k2 truncation inside the code-length estimate,
# and Cholesky pivot positivity — carry margin flags.

_SVR_OBJ_EPSILON = 1e-8          # the host's convergence epsilon
_EPS_SVR_DMAG = 1e-9             # obj-margin scale per unit of |delta|
_EPS_SVR_OBJ = 1e-10             # flag margin on objective comparisons
_EPS_SVR_PIVOT = np.float32(2.0 ** -36)
_SVR_FLT_MAX = 3.402823466e38
_SVR_LOG_OPTX = 0.5127629514     # truncated literal, as in svr.py/lpc.c


def _dd_cumsum(x, axis=1):
    return jax.lax.associative_scan(dd.add, x, axis=axis)


def _svr_cov(d, n: int, M: int, orders):
    """cov[v,i,j] = sum_{s < n-o_v} d[s+i]*d[s+j] via per-lag prefix sums of
    d[t]*d[t+l]: cov = P_l[n-o-1+i] - P_l[i-1], l = j-i."""
    V = d[0].shape[0]
    pad = (jnp.pad(d[0], ((0, 0), (0, M))), jnp.pad(d[1], ((0, 0), (0, M))))
    iidx = jnp.arange(M, dtype=jnp.int32)[None, :]
    hi_pos = jnp.clip(n - orders[:, None] - 1 + iidx, 0, n + M - 1)
    lo_pos = iidx - 1                                     # -1 -> no term

    def lag_diag(l, carry):
        dh, dl = carry
        sh = jax.lax.dynamic_slice_in_dim(pad[0], l, n, axis=1)
        sl = jax.lax.dynamic_slice_in_dim(pad[1], l, n, axis=1)
        prod = dd.mul(d, (sh, sl))
        P = _dd_cumsum(prod, axis=1)
        ah = jnp.take_along_axis(P[0], hi_pos, axis=1)
        al = jnp.take_along_axis(P[1], hi_pos, axis=1)
        bh = jnp.take_along_axis(P[0], jnp.maximum(lo_pos, 0), axis=1)
        bl = jnp.take_along_axis(P[1], jnp.maximum(lo_pos, 0), axis=1)
        none = lo_pos < 0
        bh = jnp.where(none, 0.0, bh)
        bl = jnp.where(none, 0.0, bl)
        v = dd.sub((ah, al), (bh, bl))                    # (V, M) diagonal l
        dh = jax.lax.dynamic_update_slice_in_dim(dh, v[0][None], l, axis=0)
        dl = jax.lax.dynamic_update_slice_in_dim(dl, v[1][None], l, axis=0)
        return dh, dl

    diag0 = (jnp.zeros((M, V, M), jnp.float32),
             jnp.zeros((M, V, M), jnp.float32))
    dh, dl = jax.lax.fori_loop(0, M, lag_diag, diag0)
    # Assemble the symmetric matrix from its diagonals.
    i = jnp.arange(M)[:, None]
    j = jnp.arange(M)[None, :]
    l = jnp.abs(j - i)                                    # (M, M)
    r = jnp.minimum(i, j)
    covh = dh[l, :, r]                                    # (M, M, V)
    covl = dl[l, :, r]
    return (jnp.transpose(covh, (2, 0, 1)), jnp.transpose(covl, (2, 0, 1)))


def _cholesky_dd(A, M: int, orders, eps_scale):
    """Batched df64 Cholesky of the leading o x o blocks (rows/cols >= o are
    replaced by the identity). Returns (L df (V,M,M) with columns scaled by
    inv_diag, invd df (V,M), singular (V,), risky (V,))."""
    V = A[0].shape[0]
    i_ = jnp.arange(M)
    act = (i_[None, :, None] < orders[:, None, None]) \
        & (i_[None, None, :] < orders[:, None, None])
    eye = jnp.eye(M, dtype=jnp.float32)[None]
    Ah = jnp.where(act, A[0], eye)
    Al = jnp.where(act, A[1], 0.0)

    def step(i, carry):
        Lh, Ll, idh, idl, sing, risky = carry
        rowi = (jax.lax.dynamic_slice_in_dim(Lh, i, 1, axis=1)[:, 0],
                jax.lax.dynamic_slice_in_dim(Ll, i, 1, axis=1)[:, 0])
        kmask = (jnp.arange(M) < i)[None, :]
        ri = (jnp.where(kmask, rowi[0], 0.0), jnp.where(kmask, rowi[1], 0.0))
        # s = A[i,i] - sum_k L[i,k]^2
        a_ii = (jax.lax.dynamic_slice(Ah, (0, i, i), (Lh.shape[0], 1, 1))
                [:, 0, 0],
                jax.lax.dynamic_slice(Al, (0, i, i), (Lh.shape[0], 1, 1))
                [:, 0, 0])
        s = dd.sub(a_ii, dd.sum_pairwise(dd.mul(ri, ri), axis=1))
        sv = s[0] + s[1]
        sing = sing | (sv <= 0)
        risky = risky | (jnp.abs(sv) < eps_scale)
        ssafe = (jnp.where(sv <= 0, 1.0, s[0]), jnp.where(sv <= 0, 0.0,
                                                          s[1]))
        inv = dd.div(_dd_const(1.0), dd.sqrt(ssafe))
        # L[j,i] = (A[j,i] - sum_k L[j,k] L[i,k]) * inv   (for j > i)
        colA = (jax.lax.dynamic_slice(Ah, (0, 0, i),
                                      (Lh.shape[0], M, 1))[:, :, 0],
                jax.lax.dynamic_slice(Al, (0, 0, i),
                                      (Lh.shape[0], M, 1))[:, :, 0])
        dot = dd.sum_pairwise(
            dd.mul((jnp.where(kmask[:, None, :], Lh, 0.0),
                    jnp.where(kmask[:, None, :], Ll, 0.0)),
                   (ri[0][:, None, :], ri[1][:, None, :])), axis=2)
        col = dd.mul(dd.sub(colA, dot), (inv[0][:, None], inv[1][:, None]))
        jmask = (jnp.arange(M) > i)[None, :]
        newc = (jnp.where(jmask, col[0], 0.0), jnp.where(jmask, col[1], 0.0))
        Lh = jax.lax.dynamic_update_slice(Lh, newc[0][:, :, None], (0, 0, i))
        Ll = jax.lax.dynamic_update_slice(Ll, newc[1][:, :, None], (0, 0, i))
        idh = jax.lax.dynamic_update_slice_in_dim(idh, inv[0][:, None], i,
                                                  axis=1)
        idl = jax.lax.dynamic_update_slice_in_dim(idl, inv[1][:, None], i,
                                                  axis=1)
        return Lh, Ll, idh, idl, sing, risky

    z = jnp.zeros((V, M, M), jnp.float32)
    zi = jnp.zeros((V, M), jnp.float32)
    Lh, Ll, idh, idl, sing, risky = jax.lax.fori_loop(
        0, M, step, (z, z.copy(), zi, zi.copy(), jnp.zeros(V, bool),
                     jnp.zeros(V, bool)))
    return (Lh, Ll), (idh, idl), sing, risky


def _cholesky_solve_dd(L, invd, b, M: int):
    """x = solve via forward/back substitution (host cholesky_solve parity:
    x[i] = (b[i] - sum_{j<i} L[i,j] x[j]) * invd[i], then the transpose)."""
    V = b[0].shape[0]

    def fwd(i, x):
        lrow = (jax.lax.dynamic_slice(L[0], (0, i, 0), (V, 1, M))[:, 0],
                jax.lax.dynamic_slice(L[1], (0, i, 0), (V, 1, M))[:, 0])
        kmask = (jnp.arange(M) < i)[None, :]
        s = dd.sum_pairwise(dd.mul(
            (jnp.where(kmask, lrow[0], 0.0), jnp.where(kmask, lrow[1], 0.0)),
            x), axis=1)
        bi = (jax.lax.dynamic_slice_in_dim(b[0], i, 1, axis=1)[:, 0],
              jax.lax.dynamic_slice_in_dim(b[1], i, 1, axis=1)[:, 0])
        ii = (jax.lax.dynamic_slice_in_dim(invd[0], i, 1, axis=1)[:, 0],
              jax.lax.dynamic_slice_in_dim(invd[1], i, 1, axis=1)[:, 0])
        xi = dd.mul(dd.sub(bi, s), ii)
        return (jax.lax.dynamic_update_slice_in_dim(x[0], xi[0][:, None], i,
                                                    axis=1),
                jax.lax.dynamic_update_slice_in_dim(x[1], xi[1][:, None], i,
                                                    axis=1))

    x = jax.lax.fori_loop(0, M, fwd,
                          (jnp.zeros_like(b[0]), jnp.zeros_like(b[1])))

    def bwd(t, x):
        i = M - 1 - t
        lcol = (jax.lax.dynamic_slice(L[0], (0, 0, i), (V, M, 1))[:, :, 0],
                jax.lax.dynamic_slice(L[1], (0, 0, i), (V, M, 1))[:, :, 0])
        jmask = (jnp.arange(M) > i)[None, :]
        s = dd.sum_pairwise(dd.mul(
            (jnp.where(jmask, lcol[0], 0.0), jnp.where(jmask, lcol[1], 0.0)),
            x), axis=1)
        xi0 = (jax.lax.dynamic_slice_in_dim(x[0], i, 1, axis=1)[:, 0],
               jax.lax.dynamic_slice_in_dim(x[1], i, 1, axis=1)[:, 0])
        ii = (jax.lax.dynamic_slice_in_dim(invd[0], i, 1, axis=1)[:, 0],
              jax.lax.dynamic_slice_in_dim(invd[1], i, 1, axis=1)[:, 0])
        xi = dd.mul(dd.sub(xi0, s), ii)
        return (jax.lax.dynamic_update_slice_in_dim(x[0], xi[0][:, None], i,
                                                    axis=1),
                jax.lax.dynamic_update_slice_in_dim(x[1], xi[1][:, None], i,
                                                    axis=1))

    return jax.lax.fori_loop(0, M, bwd, x)


def _rgr_code_length_dd(mean_abs, bps: int):
    """df64 twin of svr.py _rgr_mean_code_length; returns (obj df, risky)."""
    intmean = dd.mul_pow2(mean_abs, float(1 << bps))
    one = _dd_const(1.0)
    rho = dd.div(one, dd.add(one, intmean))
    om = dd.sub(one, rho)
    omv = om[0] + om[1]
    bad = omv <= 0                        # om==0: host k2 = 0 via -inf chain
    om_s = (jnp.where(bad, 0.5, om[0]), jnp.where(bad, 0.0, om[1]))
    denom = dd.log(om_s)
    lv = dd.div(_dd_const(np.log(_SVR_LOG_OPTX)), denom)
    lvv = lv[0] + lv[1]
    lv_s = (jnp.where(lvv <= 0, 1.0, lv[0]), jnp.where(lvv <= 0, 0.0, lv[1]))
    log2v = dd.mul(dd.log(lv_s), _dd_const(_INV_LOGE2))
    l2 = jnp.where(bad | (lvv <= 0), 0.0, log2v[0] + log2v[1])
    k2 = jnp.maximum(jnp.floor(l2), 0.0).astype(jnp.int32)
    risky = (~bad) & (lvv > 0) & (_dist_to_int(log2v) < 1e-9) & (l2 > 0)
    k1 = k2 + 1
    # pow(om, 2^k) by repeated squaring (k <= 31).
    def powk(k):
        def body(b, acc):
            sq = dd.mul(acc, acc)
            take = b < k
            return (jnp.where(take, sq[0], acc[0]),
                    jnp.where(take, sq[1], acc[1]))
        return jax.lax.fori_loop(0, 31, body, om)
    k1f = powk(k1)
    k2f = powk(k2)
    k1f = (jnp.where(bad, 0.0, k1f[0]), jnp.where(bad, 0.0, k1f[1]))
    k2f = (jnp.where(bad, 0.0, k2f[0]), jnp.where(bad, 0.0, k2f[1]))
    k1dd = (k1.astype(jnp.float32) + 1.0, jnp.zeros_like(l2))
    t1 = dd.mul(k1dd, dd.sub(one, k1f))
    denom2 = dd.sub(one, k2f)
    d2v = denom2[0] + denom2[1]
    denom2 = (jnp.where(d2v == 0, 1.0, denom2[0]),
              jnp.where(d2v == 0, 0.0, denom2[1]))
    inner = dd.add((k2.astype(jnp.float32) + 1.0, jnp.zeros_like(l2)),
                   dd.div(one, denom2))
    t2 = dd.mul(inner, k1f)
    return dd.add(t1, t2), risky


def _svr_exact(work, coefs, orders, n: int, bps: int, M: int,
               max_iter: int, margins, ridge: float):
    """df64 SVR refinement of the Levinson coefficients. work: (V, n) int32
    (post-preemphasis/LTP); coefs df (V, M); orders (V,). Returns
    (refined coefs df, risky (V,))."""
    V = work.shape[0]
    d = dd.mul_pow2(dd.from_int32(work), 2.0 ** (-(bps - 1)))
    cov = _svr_cov(d, n, M, orders)
    diag = jnp.eye(M, dtype=bool)[None]
    rh = dd.mul((cov[0], cov[1]), _dd_const(1.0 + ridge))
    cov = (jnp.where(diag, rh[0], cov[0]), jnp.where(diag, rh[1], cov[1]))
    eps_piv = jnp.maximum(jnp.abs(cov[0][:, 0, 0]), 1e-30) * _EPS_SVR_PIVOT
    L, invd, sing, risky = _cholesky_dd(cov, M, orders, eps_piv)

    s_ = jnp.arange(n, dtype=jnp.int32)[None, :]
    smask = s_ >= orders[:, None]
    act_i = (jnp.arange(M)[None, :] < orders[:, None])
    act3 = act_i[:, None, :] & act_i[:, :, None]
    pad = (jnp.pad(d[0], ((0, 0), (M, 0))), jnp.pad(d[1], ((0, 0), (M, 0))))

    def residual_of(cur):
        # resid[s] = d[s] + sum_i cur[i] * d[s-i-1], s >= o (else d[s]).
        def tap(i, acc):
            sh = jax.lax.dynamic_slice_in_dim(pad[0], M - 1 - i, n, axis=1)
            sl = jax.lax.dynamic_slice_in_dim(pad[1], M - 1 - i, n, axis=1)
            ci = (jax.lax.dynamic_slice_in_dim(cur[0], i, 1, axis=1),
                  jax.lax.dynamic_slice_in_dim(cur[1], i, 1, axis=1))
            term = dd.mul((sh, sl), ci)
            gate = (i < orders)[:, None]
            return (acc[0] + jnp.where(gate, term[0], 0.0),
                    acc[1] + jnp.where(gate, term[1], 0.0))
        acc = jax.lax.fori_loop(0, M, tap,
                                (jnp.zeros((V, n), jnp.float32),
                                 jnp.zeros((V, n), jnp.float32)))
        r = dd.add(d, acc)
        return (jnp.where(smask, r[0], d[0]), jnp.where(smask, r[1], d[1]))

    def rvec_of(th):
        # rvec[i] = sum_{s>=o} th[s] * d[s-1-i]
        def tap(i, acc):
            sh = jax.lax.dynamic_slice_in_dim(pad[0], M - 1 - i, n, axis=1)
            sl = jax.lax.dynamic_slice_in_dim(pad[1], M - 1 - i, n, axis=1)
            v = dd.sum_pairwise(dd.mul(th, (sh, sl)), axis=1)
            return (jax.lax.dynamic_update_slice_in_dim(
                        acc[0], v[0][:, None], i, axis=1),
                    jax.lax.dynamic_update_slice_in_dim(
                        acc[1], v[1][:, None], i, axis=1))
        return jax.lax.fori_loop(0, M, tap,
                                 (jnp.zeros((V, M), jnp.float32),
                                  jnp.zeros((V, M), jnp.float32)))

    init = coefs
    inv_n = _dd_const(1.0 / n)  # host divides by n in f64: mabse / n
    marg = jnp.asarray(np.asarray(margins, np.float64))
    mh, ml = dd.split_f64(np.asarray(margins, np.float64))
    mh = jnp.asarray(mh)
    ml = jnp.asarray(ml)
    nm = len(margins)

    def outer(k, carry):
        (cur, prev, alive, best, min_obj, dmax_c, risky) = carry
        it = jnp.remainder(k, max_iter)
        mi = k // max_iter
        # Margin start: reset the iteration state (host: cur[:] = init).
        fresh = it == 0
        cur = (jnp.where(fresh, init[0], cur[0]),
               jnp.where(fresh, init[1], cur[1]))
        prev = (jnp.where(fresh, _SVR_FLT_MAX, prev[0]),
                jnp.where(fresh, 0.0, prev[1]))
        alive = alive | fresh
        margin = (mh[mi], ml[mi])

        resid = residual_of(cur)
        rv = resid[0] + resid[1]
        ar = dd.abs_(resid)
        ar = (jnp.where(smask, ar[0], 0.0), jnp.where(smask, ar[1], 0.0))
        mabse = dd.sum_pairwise(ar, axis=1)
        # soft threshold (value-continuous; sign(0)=0 like np.sign)
        thr = dd.sub(ar, margin)
        pos = (thr[0] + thr[1]) > 0
        sgn = jnp.sign(rv)
        th = (jnp.where(pos & smask, thr[0] * sgn, 0.0),
              jnp.where(pos & smask, thr[1] * sgn, 0.0))
        rvec = rvec_of(th)
        rvec = (jnp.where(act_i, rvec[0], 0.0),
                jnp.where(act_i, rvec[1], 0.0))
        # mean code length of mabse / n  (host: f64 division)
        obj, r_obj = _rgr_code_length_dd(dd.mul(mabse, inv_n), 16)
        risky = risky | (alive & r_obj)
        delta = _cholesky_solve_dd(L, invd, rvec, M)
        # One step of iterative refinement: squashes the solve's
        # conditioning-amplified df64 error down to ~representation level,
        # so the dev-vs-host difference is dominated by the HOST's own f64
        # rounding (covered by the inflated quantize kappa).
        mv = dd.sum_pairwise(
            dd.mul((jnp.where(act3, cov[0], 0.0),
                    jnp.where(act3, cov[1], 0.0)),
                   (delta[0][:, None, :], delta[1][:, None, :])),
            axis=2)
        resd = dd.sub(rvec, mv)
        corr = _cholesky_solve_dd(L, invd, resd, M)
        delta = dd.add(delta, corr)
        # Conditioning-aware compare margin: the solve amplifies df64
        # rounding roughly in proportion to |delta|, and the objective
        # inherits that through the residual sums.
        dmag = jnp.max(jnp.where(act_i, jnp.abs(delta[0]), 0.0), axis=1)
        dmax = jnp.maximum(dmax_c, dmag)
        eps_obj = _EPS_SVR_OBJ + dmax * _EPS_SVR_DMAG
        # ALL objective comparisons in full df64 (an f32 collapse would be
        # ~2^-20-grained: decisions below that flip invisibly).
        dmin = dd.sub(obj, min_obj)
        dmin_mag = jnp.abs(dmin[0] + dmin[1]) + jnp.abs(dmin[1])
        tie_min = (dmin[0] == 0) & (dmin[1] == 0)
        adopt = alive & dd.lt(obj, min_obj)
        # An EXACT tie is not risky: both pipelines compute the same
        # deterministic value twice (strict < is false in each); only a
        # near-tie with a genuine difference can flip.
        risky = risky | (alive & ~tie_min & (dmin_mag < eps_obj))
        best = (jnp.where(adopt[:, None], cur[0], best[0]),
                jnp.where(adopt[:, None], cur[1], best[1]))
        min_obj = (jnp.where(adopt, obj[0], min_obj[0]),
                   jnp.where(adopt, obj[1], min_obj[1]))
        dprev = dd.sub(prev, obj)
        tie_prev = (dprev[0] == 0) & (dprev[1] == 0)
        dobj = dd.abs_(dprev)
        dobj_mag = dobj[0] + dobj[1]
        eps_dd = _dd_const(_SVR_OBJ_EPSILON)
        a_dec = dd.lt(prev, obj)
        b_dec = dd.lt(dobj, (jnp.broadcast_to(eps_dd[0], dobj[0].shape),
                             jnp.broadcast_to(eps_dd[1], dobj[1].shape)))
        stop = a_dec | b_dec
        # stop = A | B. Flag only where the OUTCOME is uncertain: B on its
        # boundary, or A ambiguous while B is not certainly true.
        b_unc = jnp.abs(dobj_mag - _SVR_OBJ_EPSILON) < eps_obj
        a_unc = ~tie_prev & (dobj_mag < eps_obj)
        b_true = dobj_mag < _SVR_OBJ_EPSILON - eps_obj
        risky = risky | (alive & (b_unc | (a_unc & ~b_true)))
        step_c = dd.add(cur, delta)
        live2 = (alive & ~stop)[:, None]
        cur = (jnp.where(live2 & act_i, step_c[0], cur[0]),
               jnp.where(live2 & act_i, step_c[1], cur[1]))
        prev = (jnp.where(alive, obj[0], prev[0]),
                jnp.where(alive, obj[1], prev[1]))
        alive = alive & ~stop
        return (cur, prev, alive, best, min_obj, dmax, risky)

    fmax = jnp.full(V, _SVR_FLT_MAX, jnp.float32)
    zv = jnp.zeros(V, jnp.float32)
    carry = (init, (fmax, zv), jnp.zeros(V, bool), coefs, (fmax, zv),
             jnp.zeros(V, jnp.float32), risky)
    (cur, prev, alive, best, min_obj, dmax_c, risky) = jax.lax.fori_loop(
        0, nm * max_iter, outer, carry)
    del marg
    # Singular covariance: the host returns zero coefficients.
    on = (orders > 0) & ~sing
    out = (jnp.where(on[:, None] & act_i, best[0], 0.0),
           jnp.where(on[:, None] & act_i, best[1], 0.0))
    zero_case = (orders > 0) & sing
    out = (jnp.where(zero_case[:, None], 0.0, out[0]),
           jnp.where(zero_case[:, None], 0.0, out[1]))
    return out, risky, dmax_c


# ---------------------------------------------------------------------------
# Long-term (pitch) prediction in df64 (parity: lpc.c:1473-1649)
# ---------------------------------------------------------------------------

_LTP_EPS_REL = np.float32(2.0 ** -36)   # compare margins, relative to ac[0]
_EPS_LTP_QUANT = 1e-6                    # quantized-units rounding margin
_PITCH_MAX_CAND = 20                     # MAX_NUM_PITCH_CANDIDATES
_PITCH_THRESH = 0.1                      # PITCH_AUTOCORR_THRESHOLD
_PITCH_RATIO = 0.9                       # PITCH_RATIO_VS_MAX_THRESHOLD
_FLT_MIN = 1.1754943508222875e-38


def _ltp_exact(work: jnp.ndarray, n: int, bps: int, fft_size: int,
               ltp_order: int, min_period: int, max_period: int):
    """Pitch detect + LTP solve + coefficient quantize, df64 with boundary
    flagging. Returns (periods (V,) int32 — 0 = disabled, coefs_rev
    (V, ltp_order) int32 in emission order, risky (V,) bool).

    The reference's zero-crossing-bracketed peak scan (detect_pitch) is a
    sequential cursor loop; here it is ONE lax.scan over the lag axis with a
    per-row {seeking, in-segment} state machine, vectorized over variants.
    Every comparison that feeds a discrete outcome (crossing signs, peak
    tests, the running local/global maxima, the 0.1*ac[0] threshold and the
    0.9*max ratio, Cholesky pivot positivity, coefficient rounding) carries
    a margin test against the df64-vs-f64 error bound; close calls flag the
    row for host re-derivation.
    """
    V = work.shape[0]
    max_lag = max_period + 1
    ach, acl = _autocorr_dd(work, n, bps, max_lag, fft_size)
    pad = (max_period + 3 + 1) - max_lag      # host acbuf zero tail + guard
    ach = jnp.pad(ach, ((0, 0), (0, pad)))
    acl = jnp.pad(acl, ((0, 0), (0, pad)))
    ac0 = (ach[:, 0], acl[:, 0])
    eps = jnp.abs(ac0[0]) * _LTP_EPS_REL
    zero = jnp.zeros((V,), jnp.float32)

    def colv(j, off):
        h = jax.lax.dynamic_slice_in_dim(ach, j + off, 1, axis=1)[:, 0]
        lo = jax.lax.dynamic_slice_in_dim(acl, j + off, 1, axis=1)[:, 0]
        return h, lo

    def near(a, b):
        return jnp.abs((a[0] - b[0]) + (a[1] - b[1])) < eps

    def step(carry, j):
        inseg, sp_h, sp_l, sidx, ncand, mp_h, mp_l, cands, risky = carry
        am1 = colv(j, -1)
        a0 = colv(j, 0)
        ap1 = colv(j, 1)
        zz = (zero, zero)
        cross = dd.lt(am1, zz) & dd.gt(a0, zz)
        risky = risky | near(am1, zz) | near(a0, zz)
        enter = (~inseg) & (ncand < _PITCH_MAX_CAND) & cross
        sp_h = jnp.where(enter, 0.0, sp_h)
        sp_l = jnp.where(enter, 0.0, sp_l)
        sidx = jnp.where(enter, 0, sidx)
        inseg = inseg | enter
        # Peak test at j (strict > both neighbors, > running local peak).
        pk = inseg & dd.gt(a0, am1) & dd.gt(a0, ap1)
        risky = risky | (inseg & (near(a0, am1) | near(a0, ap1)))
        better = pk & dd.gt(a0, (sp_h, sp_l))
        risky = risky | (pk & near(a0, (sp_h, sp_l)))
        sp_h = jnp.where(better, a0[0], sp_h)
        sp_l = jnp.where(better, a0[1], sp_l)
        sidx = jnp.where(better, j, sidx)
        # Segment close: first pos->neg crossing at or after start+1.
        close = inseg & (~enter) & (j < max_period - 1) \
            & dd.gt(a0, zz) & dd.lt(ap1, zz)
        risky = risky | (inseg & (~enter) & (near(a0, zz) | near(ap1, zz)))
        fin = close & (sidx != 0)
        slot = jnp.arange(_PITCH_MAX_CAND, dtype=jnp.int32)[None, :]
        upd = fin[:, None] & (slot == ncand[:, None])
        cands = jnp.where(upd, sidx[:, None], cands)
        adopt = fin & dd.gt((sp_h, sp_l), (mp_h, mp_l))
        risky = risky | (fin & near((sp_h, sp_l), (mp_h, mp_l)))
        mp_h = jnp.where(adopt, sp_h, mp_h)
        mp_l = jnp.where(adopt, sp_l, mp_l)
        ncand = ncand + fin.astype(jnp.int32)
        inseg = inseg & ~close
        return (inseg, sp_h, sp_l, sidx, ncand, mp_h, mp_l, cands,
                risky), None

    init = (jnp.zeros(V, bool), zero, zero, jnp.zeros(V, jnp.int32),
            jnp.zeros(V, jnp.int32), zero, zero,
            jnp.zeros((V, _PITCH_MAX_CAND), jnp.int32), jnp.zeros(V, bool))
    (inseg, sp_h, sp_l, sidx, ncand, mp_h, mp_l, cands, risky), _ = \
        jax.lax.scan(step, init,
                     jnp.arange(min_period, max_period, dtype=jnp.int32))
    # Unclosed trailing segment: the serial loop still appends its peak.
    fin = inseg & (sidx != 0)
    slot = jnp.arange(_PITCH_MAX_CAND, dtype=jnp.int32)[None, :]
    upd = fin[:, None] & (slot == ncand[:, None])
    cands = jnp.where(upd, sidx[:, None], cands)
    adopt = fin & dd.gt((sp_h, sp_l), (mp_h, mp_l))
    risky = risky | (fin & near((sp_h, sp_l), (mp_h, mp_l)))
    mp_h = jnp.where(adopt, sp_h, mp_h)
    mp_l = jnp.where(adopt, sp_l, mp_l)
    ncand = ncand + fin.astype(jnp.int32)
    mp = (mp_h, mp_l)

    # Threshold and first-qualifying-candidate selection.
    thresh = dd.mul(ac0, _dd_const(_PITCH_THRESH))
    ok = (ncand > 0) & ~dd.lt(mp, thresh)
    risky = risky | near(mp, thresh)
    ratio = dd.mul(mp, _dd_const(_PITCH_RATIO))
    cv_h = jnp.take_along_axis(ach, cands, axis=1)
    cv_l = jnp.take_along_axis(acl, cands, axis=1)
    live = slot < ncand[:, None]
    qual = live & ~((cv_h < ratio[0][:, None])
                    | ((cv_h == ratio[0][:, None])
                       & (cv_l < ratio[1][:, None])))
    risky = risky | jnp.any(
        live & (jnp.abs((cv_h - ratio[0][:, None])
                        + (cv_l - ratio[1][:, None])) < eps[:, None]),
        axis=1)
    first = jnp.argmax(qual, axis=1)
    period = jnp.where(ok & jnp.any(qual, axis=1),
                       jnp.take_along_axis(cands, first[:, None],
                                           axis=1)[:, 0], 0)
    # |ac[0]| <= FLT_MIN and short-period guards (integer-exact).
    tiny = jnp.abs(ac0[0]) <= _FLT_MIN
    risky = risky | (jnp.abs(jnp.abs(ac0[0]) - _FLT_MIN) < 1e-38)
    period = jnp.where(tiny, 0, period)
    period = jnp.where(period < (ltp_order // 2) + 1, 0, period)

    # Cholesky solve (dim = ltp_order <= 3), df64, unrolled.
    ridge = _dd_const(1.0 + LPC_RIDGE_REGULARIZATION_PARAMETER)
    a0r = dd.mul(ac0, ridge)
    lag = lambda i: (ach[:, i], acl[:, i])  # noqa: E731

    def rhs(i):
        idx = jnp.clip(period - (ltp_order // 2) + i, 0,
                       ach.shape[1] - 1)[:, None]
        return (jnp.take_along_axis(ach, idx, axis=1)[:, 0],
                jnp.take_along_axis(acl, idx, axis=1)[:, 0])

    eps_pos = jnp.abs(a0r[0]) * _LTP_EPS_REL
    if ltp_order == 1:
        s0 = a0r
        singular = s0[0] + s0[1] <= 0
        risky = risky | (jnp.abs(s0[0] + s0[1]) < eps_pos)
        inv0 = dd.div(_dd_const(1.0), dd.sqrt(s0))
        x0 = dd.mul(rhs(0), dd.mul(inv0, inv0))
        coefs = [x0]
    else:
        # A = [[r0' r1 r2],[r1 r0' r1],[r2 r1 r0']]; forward then back subst.
        r1, r2 = lag(1), lag(2)
        s0 = a0r
        singular = s0[0] + s0[1] <= 0
        risky = risky | (jnp.abs(s0[0] + s0[1]) < eps_pos)
        d0 = dd.div(_dd_const(1.0), dd.sqrt(s0))
        l10 = dd.mul(r1, d0)
        l20 = dd.mul(r2, d0)
        s1 = dd.sub(a0r, dd.mul(l10, l10))
        singular = singular | (s1[0] + s1[1] <= 0)
        risky = risky | (jnp.abs(s1[0] + s1[1]) < eps_pos)
        d1 = dd.div(_dd_const(1.0), dd.sqrt(s1))
        l21 = dd.mul(dd.sub(r1, dd.mul(l20, l10)), d1)
        s2 = dd.sub(dd.sub(a0r, dd.mul(l20, l20)), dd.mul(l21, l21))
        singular = singular | (s2[0] + s2[1] <= 0)
        risky = risky | (jnp.abs(s2[0] + s2[1]) < eps_pos)
        d2 = dd.div(_dd_const(1.0), dd.sqrt(s2))
        b0, b1, b2 = rhs(0), rhs(1), rhs(2)
        y0 = dd.mul(b0, d0)
        y1 = dd.mul(dd.sub(b1, dd.mul(l10, y0)), d1)
        y2 = dd.mul(dd.sub(dd.sub(b2, dd.mul(l20, y0)), dd.mul(l21, y1)),
                    d2)
        x2 = dd.mul(y2, d2)
        x1 = dd.mul(dd.sub(y1, dd.mul(l21, x2)), d1)
        x0 = dd.mul(dd.sub(dd.sub(y0, dd.mul(l10, x1)), dd.mul(l20, x2)),
                    d0)
        coefs = [x0, x1, x2]
    period = jnp.where(singular, 0, period)

    # Quantize: round-half-away(c * 32), clip [-32, 31], reversed emission
    # order (encoder.py:224-227).
    qcoefs = []
    for c in coefs:
        scaled = dd.mul_pow2(c, 32.0)
        q = dd.round_half_away(scaled)
        risky = risky | ((period > 0)
                         & (_dist_to_half(scaled) < _EPS_LTP_QUANT))
        qv = jnp.clip(q[0] + q[1], -32.0, 31.0)
        qcoefs.append(qv.astype(jnp.int32))
    coefs_rev = jnp.stack(qcoefs[::-1], axis=1)
    coefs_rev = jnp.where((period > 0)[:, None], coefs_rev, 0)
    return period.astype(jnp.int32), coefs_rev, risky


def _ltp_predict_dev(work: jnp.ndarray, coefs_rev: jnp.ndarray,
                     periods: jnp.ndarray, ltp_order: int) -> jnp.ndarray:
    """Integer LTP prediction filter, exact int32 wrap (dsp/predict.py
    ltp_predict): out[s] = x[s] - ((half + sum_i c[i]*x[s-delay+i]) >> rs)
    for s >= delay+1, x the unfiltered input throughout."""
    V, n = work.shape
    rs = LTP_COEFFICIENT_BITWIDTH - 1
    half = jnp.int32(1 << (rs - 1))
    delay = periods + (ltp_order >> 1)
    s = jnp.arange(n, dtype=jnp.int32)[None, :]
    acc = jnp.full((V, n), half, jnp.int32)
    for i in range(ltp_order):
        idx = jnp.clip(s - delay[:, None] + i, 0, n - 1)
        acc = acc + coefs_rev[:, i:i + 1] * jnp.take_along_axis(work, idx,
                                                                axis=1)
    pred = acc >> rs
    on = (periods > 0)[:, None] & (s >= (delay + 1)[:, None])
    return jnp.where(on, work - pred, work)


def _analyze_core_exact(sig: jnp.ndarray, *, n: int, bps: int,
                        max_params: int, max_fixed: bool, fft_size: int,
                        max_porder: int, ltp_order: int = 0,
                        svr_iter: int = 0, margins: tuple = ()):
    work, pre_coef, risky = _preemphasis_exact(sig)
    pre_prev = sig[:, 0]
    V = sig.shape[0]
    ltp_period = jnp.zeros(V, jnp.int32)
    ltp_coefs = jnp.zeros((V, max(ltp_order, 1)), jnp.int32)
    if ltp_order > 0:
        from ..constants import LTP_MAX_PERIOD, LTP_MIN_PERIOD
        ltp_period, ltp_coefs, r_ltp = _ltp_exact(
            work, n, bps, fft_size, ltp_order, LTP_MIN_PERIOD,
            LTP_MAX_PERIOD)
        work = _ltp_predict_dev(work, ltp_coefs, ltp_period, ltp_order)
        risky = risky | r_ltp
    if max_params > 0:
        ac = _autocorr_dd(work, n, bps, max_params + 1, fft_size)
        ridge = _dd_const(1.0 + LPC_RIDGE_REGULARIZATION_PARAMETER)
        ac0 = dd.mul((ac[0][:, 0], ac[1][:, 0]), ridge)
        ac = (ac[0].at[:, 0].set(ac0[0]), ac[1].at[:, 0].set(ac0[1]))
        ev, _, silent, r_lev, kappa = _levinson_dd(ac, max_params, None)
        winv = _dd_const(welch_inverse_squared_sum(n))
        evc = dd.mul(ev, (jnp.broadcast_to(winv[0], ev[0].shape),
                          jnp.broadcast_to(winv[1], ev[1].shape)))
        orders, r_ord = _select_order_exact(evc, n, bps, max_params,
                                            max_fixed, kappa)
        _, coefs, _, _, _ = _levinson_dd(ac, max_params, orders)
        if svr_iter > 0:
            coefs, r_svr, svr_dmax = _svr_exact(
                work, coefs, orders, n, bps, max_params, svr_iter, margins,
                LPC_RIDGE_REGULARIZATION_PARAMETER)
            risky = risky | r_svr
            # SVR iteration chaos: dev-vs-host coef divergence measures
            # ~|delta|max * 2^-34 (conditioning-amplified, compounded over
            # iterations); widen the quantize boundary margin accordingly
            # (kappa enters eps_k as 2*qmax*kappa*2^-40 quantized units).
            kappa = jnp.maximum(kappa, svr_dmax * 512.0)
        intc, rshifts, r_q = _quantize_exact(
            coefs, orders, LPC_COEFFICIENT_BITWIDTH,
            1 << RSHIFT_LPC_COEFFICIENT_BITWIDTH, kappa)
        rshifts = jnp.where(orders > 0, rshifts, 0)
        coefs_rev = _reverse_coefs(intc, orders)
        residual = _predict(work, coefs_rev, orders, rshifts, n)
        risky = risky | r_lev | r_ord | r_q
    else:
        orders = jnp.zeros(V, jnp.int32)
        rshifts = jnp.zeros(V, jnp.int32)
        coefs_rev = jnp.zeros((V, 1), jnp.int32)
        residual = work
    code_type, porder, rice_bits, ks, r_rice = _rice_exact(residual, n,
                                                           max_porder)
    risky = risky | r_rice
    return dict(pre_prev=pre_prev, pre_coef=pre_coef, orders=orders,
                rshifts=rshifts, coefs=coefs_rev, residual=residual,
                code_type=code_type, porder=porder, rice_bits=rice_bits,
                ks=ks, risky=risky,
                ltp_period=ltp_period, ltp_coefs=ltp_coefs)


def _variant_analysis(blocks, lshift, *, n, bps, max_params, max_fixed,
                      fft_size, max_porder, C, ltp_order=0, svr_iter=0,
                      margins=()):
    """Shared trace: stack stereo variants on device, run the exact core."""
    work = blocks.astype(jnp.int32) >> lshift
    parts = []
    if C >= 2:
        s = work[:, 1] - work[:, 0]
        m = work[:, 0] + (s >> 1)
        parts.extend([m, s])
    parts.extend(work[:, c] for c in range(C))
    sig = jnp.concatenate(parts, axis=0)
    with dd.pinned(lshift):
        out = _analyze_core_exact(sig, n=n, bps=bps, max_params=max_params,
                                  max_fixed=max_fixed, fft_size=fft_size,
                                  max_porder=max_porder,
                                  ltp_order=ltp_order, svr_iter=svr_iter,
                                  margins=margins)
    u = _zigzag(out["residual"])
    small = {k: out[k] for k in ("pre_prev", "pre_coef", "orders", "rshifts",
                                 "coefs", "code_type", "porder",
                                 "ltp_period", "ltp_coefs", "risky")}
    small["section_bits"] = out["rice_bits"]
    return small, u, out


@partial(jax.jit, static_argnames=("n", "bps", "max_params", "max_fixed",
                                   "fft_size", "max_porder", "C",
                                   "ltp_order", "svr_iter", "margins"))
def measure_spans_exact(file: jnp.ndarray, offs: jnp.ndarray, lshift, *,
                        n: int, bps: int, max_params: int, max_fixed: bool,
                        fft_size: int, max_porder: int, C: int,
                        ltp_order: int = 0, svr_iter: int = 0,
                        margins: tuple = ()):
    """Span measurement for the -V partition search.

    The -V search measures every candidate span of every lookahead window —
    ~(dmax/dmin)x the file's samples. Stacking those overlapping spans on
    host and uploading them re-sends the file ~4x per search
    (srla_encoder.c:310-424 is the same measured-edge search, but its cost
    is compute; ours was the host->device link). Here the file crosses the
    link ONCE as a (C, N) resident array and every (offset, n) span is cut
    on device; only the decision-sized outputs come back.

    file: (C, N) int (int16 ok); offs: (Bp,) int32 with off + n <= N.
    Returns the `small` dict of analyze_blocks_exact (bit accounting inputs
    + risky flags); the residual pack is never materialized.
    """
    blocks = jax.vmap(
        lambda o: jax.lax.dynamic_slice(file, (0, o), (C, n)))(offs)
    small, _u, _out = _variant_analysis(
        blocks, lshift, n=n, bps=bps, max_params=max_params,
        max_fixed=max_fixed, fft_size=fft_size, max_porder=max_porder, C=C,
        ltp_order=ltp_order, svr_iter=svr_iter, margins=margins)
    return {k: small[k] for k in ("section_bits", "orders", "coefs",
                                  "risky", "ltp_period")}


@partial(jax.jit, static_argnames=("n", "bps", "max_params", "max_fixed",
                                   "fft_size", "max_porder", "C",
                                   "ltp_order", "svr_iter", "margins"))
def analyze_blocks_exact(blocks: jnp.ndarray, lshift, *, n: int, bps: int,
                         max_params: int, max_fixed: bool, fft_size: int,
                         max_porder: int, C: int, ltp_order: int = 0,
                         svr_iter: int = 0, margins: tuple = ()):
    """Exact-decision variant analysis (no SVR; the encoder routes that
    to the host until its exact device pipeline lands).

    Same contract as kernels/encode.py:analyze_blocks_ex, plus
    small['risky']: variants whose decisions are too boundary-close to prove
    equal to the host's f64 pipeline and must be host-re-derived.
    """
    small, u, out = _variant_analysis(
        blocks, lshift, n=n, bps=bps, max_params=max_params,
        max_fixed=max_fixed, fft_size=fft_size, max_porder=max_porder, C=C,
        ltp_order=ltp_order, svr_iter=svr_iter, margins=margins)
    big = dict(u=u, code_type=out["code_type"], porder=out["porder"],
               ks=out["ks"])
    return small, big


# ------------------------------------------------------------------ #
# Fused encode: selection + packing in the analysis dispatch          #
# ------------------------------------------------------------------ #
# Every dispatch and every fetch is a host-device synchronization point;
# the fastest schedule is the one with the fewest of them. This program
# therefore carries one
# chunk all the way from samples to a compacted bitstream buffer: analysis,
# exact bit accounting (Huffman length LUTs), the stereo-method argmin, the
# raw-fallback decision, chosen-row packing, and compaction — ONE dispatch,
# then one small fetch (parameters) and one exact-size payload fetch.
# Parity: srla_encoder.c:1121-1187 (accounting), :1323-1367 (selection).

_hl_cache = {}


def _huffman_len_tables():
    if "t" not in _hl_cache:
        from ..huffman import parameter_codebook, sum_parameter_codebook
        _hl_cache["t"] = (
            np.asarray(parameter_codebook().lengths, np.int32),
            np.asarray(sum_parameter_codebook().lengths, np.int32))
    return _hl_cache["t"]


def _zig32(x):
    return ((x << 1) ^ (x >> 31)).astype(jnp.uint32)


def _account_bits_dev(sec_bits, orders, coefs, bps: int):
    """Device twin of SRLAEncoder._account_bits (no-LTP form): exact
    per-variant code length and the direct-vs-summed coefficient choice."""
    plens_np, slens_np = _huffman_len_tables()
    plens = jnp.asarray(plens_np)
    slens = jnp.asarray(slens_np)
    V, M = coefs.shape
    mask = jnp.arange(M)[None, :] < orders[:, None]
    uv = _zig32(coefs)
    uvc = jnp.minimum(uv, 255).astype(jnp.int32)
    coef_cost = jnp.sum(jnp.where(mask, plens[uvc], 0), axis=1)
    summed = coefs[:, 1:] + coefs[:, :-1]          # int32 wrap == host
    suv = _zig32(summed)
    smask = mask[:, 1:]
    svalid = jnp.all(~smask | (suv < 256), axis=1)
    suvc = jnp.minimum(suv, 255).astype(jnp.int32)
    sum_cost = plens[uvc[:, 0]] + jnp.sum(jnp.where(smask, slens[suvc], 0),
                                          axis=1)
    use_sum = (orders > 0) & svalid & ((orders == 1)
                                       | (sum_cost < coef_cost))
    coef_bits = jnp.where(orders > 0,
                          jnp.where(use_sum, sum_cost, coef_cost), 0)
    fixed = (bps + 1 + (PREEMPHASIS_COEF_SHIFT + 1)
             + LPC_COEFFICIENT_ORDER_BITWIDTH
             + RSHIFT_LPC_COEFFICIENT_BITWIDTH + 1 + 1)
    return sec_bits.astype(jnp.int32) + fixed + coef_bits, use_sum


@partial(jax.jit, static_argnames=("n", "bps", "max_params", "max_fixed",
                                   "fft_size", "max_porder", "C", "W",
                                   "impl", "ltp_order", "svr_iter",
                                   "margins"))
def encode_blocks_exact(blocks: jnp.ndarray, lshift, *, n: int, bps: int,
                        max_params: int, max_fixed: bool, fft_size: int,
                        max_porder: int, C: int, W: int,
                        impl: str = "scatter", ltp_order: int = 0,
                        svr_iter: int = 0, margins: tuple = ()):
    """Fused exact encode of one equal-size block group.

    Returns (small, flat): `small` holds the per-variant parameters plus the
    per-block selection results — method, raw-fallback mask, risky mask —
    and the per-(block,channel) packed-section word lengths `lens_w` (row
    r = block*C + channel; zero rows were not packed: raw fallback, risky
    block, or W overflow). `flat` is a (Bp*C*W,) word buffer whose first
    sum(lens_w) words are the chosen residual sections, bit-packed and
    compacted in row order; the caller fetches exactly that prefix.
    """
    from .bitpack import pack_residual_sections

    small, u, out = _variant_analysis(
        blocks, lshift, n=n, bps=bps, max_params=max_params,
        max_fixed=max_fixed, fft_size=fft_size, max_porder=max_porder, C=C,
        ltp_order=ltp_order, svr_iter=svr_iter, margins=margins)
    nvar = C + 2 if C >= 2 else 1
    Bp = blocks.shape[0]
    maxp = max(max_params, 1)
    code_len, use_sum = _account_bits_dev(
        small["section_bits"], small["orders"], small["coefs"][:, :maxp],
        bps)
    if ltp_order > 0:
        code_len = code_len + jnp.where(
            small["ltp_period"] > 0,
            LTP_ORDER_BITWIDTH + LTP_PERIOD_BITWIDTH
            + ltp_order * LTP_COEFFICIENT_BITWIDTH, 0)

    cl = code_len.reshape(nvar, Bp)
    if C >= 2:
        lens4 = jnp.stack([cl[2] + cl[3], cl[0] + cl[1],
                           cl[2] + cl[1], cl[3] + cl[1]])
        method = jnp.argmin(lens4, axis=0).astype(jnp.int32)
        bits = jnp.take_along_axis(lens4, method[None, :], axis=0)[0]
    else:
        method = jnp.zeros(Bp, jnp.int32)
        bits = cl[0]
    bits = ((bits + 2 + 7) // 8) * 8
    raw_blk = bits >= bps * n * C
    risky_blk = small["risky"].reshape(nvar, Bp).any(axis=0)

    # Chosen variant row per (block, channel), r = bi*C + c.
    bi = jnp.arange(Bp, dtype=jnp.int32)[:, None]
    ci = jnp.arange(C, dtype=jnp.int32)[None, :]
    if C >= 2:
        m = method[:, None]
        vix = jnp.where((m == 1) & (ci < 2), ci,
                        jnp.where(((m == 2) & (ci == 1))
                                  | ((m == 3) & (ci == 0)), 1, 2 + ci))
    else:
        vix = jnp.zeros((Bp, 1), jnp.int32)
    rows = (vix * Bp + bi).reshape(-1)

    sec = small["section_bits"][rows].astype(jnp.int32)
    skip = (raw_blk | risky_blk)[:, None] | (sec.reshape(Bp, C) > W * 32)
    lens_w = jnp.where(skip.reshape(-1), 0, (sec + 31) // 32)
    csum = jnp.cumsum(lens_w)
    starts = (csum - lens_w).astype(jnp.int32)
    K = Bp * C
    cap = K * W

    if impl == "flat":
        # Absolute-offset grouped-window pack: every chosen row's section is
        # packed straight at its final flat position (starts from the lens_w
        # cumsum), producing the compacted output in ONE scatter-free pass,
        # in place of the per-row scatter pack + searchsorted row
        # compaction of impl="scatter".
        from .bitpack import pack_flat_stream, residual_codewords
        (offs, tails, tbits), _tot = residual_codewords(
            u[rows], out["code_type"][rows], out["porder"][rows],
            out["ks"][rows], n)
        skip_r = skip.reshape(-1)
        # Skipped rows collapse onto their (zero-length) boundary so the
        # flattened offset stream stays monotone for the group anchors.
        offs = jnp.where(skip_r[:, None], 0, offs) + starts[:, None] * 32
        tbits = jnp.where(skip_r[:, None], 0, tbits)
        T = offs.shape[1]
        G = 64
        padT = (-T) % G
        if padT:
            endo = offs[:, -1:] + tbits[:, -1:]      # running cursor
            offs = jnp.concatenate(
                [offs, jnp.broadcast_to(endo, (K, padT))], axis=1)
            tails = jnp.pad(tails, ((0, 0), (0, padT)))
            tbits = jnp.pad(tbits, ((0, 0), (0, padT)))
        flat, g_ovf = pack_flat_stream(offs, tails, tbits, cap, G=G)
        ovf = jnp.any(g_ovf, axis=1)
    else:
        words, _, ovf = pack_residual_sections(
            u[rows], out["code_type"][rows], out["porder"][rows],
            out["ks"][rows], n, W, impl)
        j = jnp.arange(cap, dtype=jnp.int32)
        seg = jnp.clip(jnp.searchsorted(starts, j, side="right") - 1, 0,
                       K - 1)
        col = j - starts[seg]
        ok = (col >= 0) & (col < lens_w[seg])
        flat = jnp.where(ok, words[seg, jnp.clip(col, 0, W - 1)], 0)

    small["method"] = method
    small["bits"] = bits
    small["raw_blk"] = raw_blk
    small["risky_blk"] = risky_blk
    small["use_sum"] = use_sum
    small["lens_w"] = lens_w
    small["pack_ovf"] = ovf
    return small, flat
