"""f32 approx encode analysis (JAX, single jitted program over all blocks).

Design: the block axis is the vector axis. Every stage — pre-emphasis
statistics, Welch window, FFT autocorrelation, Levinson-Durbin, order
selection, quantization, the int32 FIR, and the Rice cost/partition search —
runs batched over (num_blocks * num_variants) at once. Float analysis runs in
f32 (parameter choices may differ from the exact f64 host path occasionally;
the emitted stream is still valid and lossless because the residual is
computed with the exact wrapping-int32 FIR from the quantized coefficients).

Structure mirrors srla_tpu/encoder.py's host pipeline; that module is the
bit-exact oracle for this one.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (CODER_LOG2_MAX_NUM_PARTITIONS,
                         LPC_COEFFICIENT_BITWIDTH,
                         LPC_RIDGE_REGULARIZATION_PARAMETER,
                         LTP_COEFFICIENT_BITWIDTH, LTP_MAX_PERIOD,
                         LTP_MIN_PERIOD, PREEMPHASIS_COEF_SHIFT)
from ..dsp.window import welch_inverse_squared_sum
from ..rice import MLNOPTX

_INV_LOGE2 = 1.4426950408889634
_FLT_MAX = 3.402823466e38


def _welch_f32(n: int) -> np.ndarray:
    s = np.arange(n, dtype=np.float64)
    w = (4.0 / (n - 1) ** 2) * s * (n - 1 - s)
    return w.astype(np.float32)


def _preemphasis(sig: jnp.ndarray):
    x = sig.astype(jnp.float32)
    r0 = jnp.sum(x * x, axis=1)
    r1 = jnp.sum(x[:, :-1] * x[:, 1:], axis=1)
    coef = jnp.where(
        r0 < 1e-6, 0,
        jnp.clip(jnp.round(16.0 * r1 / jnp.maximum(r0, 1e-30)),
                 -(1 << PREEMPHASIS_COEF_SHIFT),
                 (1 << PREEMPHASIS_COEF_SHIFT) - 1)).astype(jnp.int32)
    prev = jnp.concatenate([sig[:, :1], sig[:, :-1]], axis=1)
    pred = (prev * coef[:, None]) >> PREEMPHASIS_COEF_SHIFT
    return sig - pred, coef


def _autocorr(work: jnp.ndarray, n: int, bps: int, order: int,
              fft_size: int) -> jnp.ndarray:
    w = jnp.asarray(_welch_f32(n))
    d = work.astype(jnp.float32) * np.float32(2.0 ** (-(bps - 1))) * w
    if fft_size > n:
        d = jnp.pad(d, ((0, 0), (0, fft_size - n)))
    spec = jnp.fft.rfft(d)
    power = spec.real * spec.real + spec.imag * spec.imag
    ac = jnp.fft.irfft(power)
    return ac[:, :order]


def _levinson(ac: jnp.ndarray, max_order: int, orders: jnp.ndarray | None):
    """Batched Levinson-Durbin: fori_loop over recursion order, vectorized
    over the variant axis. Returns (error_vars (V, M+1), coefs at per-variant
    `orders` (V, M) left-aligned, or None)."""
    V = ac.shape[0]
    M = max_order
    r0 = ac[:, 0]
    safe_r0 = jnp.where(jnp.abs(r0) < 1e-30, 1.0, r0)
    a = jnp.zeros((V, M + 2), jnp.float32).at[:, 0].set(1.0)
    a = a.at[:, 1].set(-ac[:, 1] / safe_r0)
    ev = jnp.zeros((V, M + 1), jnp.float32).at[:, 0].set(r0)
    ev = ev.at[:, 1].set(r0 + ac[:, 1] * a[:, 1])
    collect = orders is not None
    collected = jnp.zeros((V, M), jnp.float32)
    if collect:
        first = jnp.pad(a[:, 1:2], ((0, 0), (0, M - 1)))
        collected = jnp.where((orders == 1)[:, None], first, collected)

    # acflip_pad[j] = ac[M+1-j] for j <= M+1, 0 beyond.
    ac_ext = jnp.pad(ac, ((0, 0), (0, 1)))            # (V, M+2)
    acflip_pad = jnp.pad(ac_ext[:, ::-1], ((0, 0), (0, M + 2)))
    aidx = jnp.arange(M + 2)

    def body(k, carry):
        # Loop var k corresponds to the reference recursion step k+1:
        # gamma over ac[(k+1)+1-i], error vars ev[k+1] -> ev[k+2].
        a, ev, collected = carry
        win = jax.lax.dynamic_slice_in_dim(acflip_pad, M - k - 1, M + 2,
                                           axis=1)   # win[i] = ac[k+2-i]
        gamma = jnp.sum(a * win, axis=1)
        evk = jax.lax.dynamic_slice_in_dim(ev, k + 1, 1, axis=1)[:, 0]
        gamma = gamma / -jnp.where(jnp.abs(evk) < 1e-30, 1.0, evk)
        ev_next = evk * (1.0 - gamma * gamma)
        ev = jax.lax.dynamic_update_slice_in_dim(ev, ev_next[:, None], k + 2,
                                                 axis=1)
        # a_new[i] = a[i] + gamma * a[k+2-i], for i <= k+2.
        aflip_pad = jnp.pad(a[:, ::-1], ((0, 0), (0, M + 2)))
        arev = jax.lax.dynamic_slice_in_dim(aflip_pad, M - k - 1, M + 2,
                                            axis=1)
        a_new = jnp.where((aidx <= k + 2)[None, :],
                          a + gamma[:, None] * arev, 0.0)
        if collect:
            sel = (orders == (k + 2))[:, None]
            collected = jnp.where(sel, a_new[:, 1:M + 1], collected)
        return (a_new, ev, collected)

    if M > 1:
        a, ev, collected = jax.lax.fori_loop(0, M - 1, body,
                                             (a, ev, collected))
    silent = (jnp.abs(r0) < np.float32(1.1920928955078125e-07))[:, None]
    ev = jnp.where(silent, r0[:, None], ev)
    collected = jnp.where(silent, 0.0, collected)
    return ev, (collected if collect else None)


def _select_order(ev: jnp.ndarray, n: int, bps: int, max_params: int,
                  max_fixed: bool) -> jnp.ndarray:
    V = ev.shape[0]
    if max_fixed:
        return jnp.full((V,), max_params, jnp.int32)
    winv = np.float32(welch_inverse_squared_sum(n))
    orders_ax = jnp.arange(1, max_params + 1, dtype=jnp.float32)
    mabse = 2.0 * jnp.sqrt(jnp.maximum(ev[:, 1:] * winv, 0.0) / 2.0)
    intmean = mabse * np.float32(1 << (bps - 1))
    rho = 1.0 / (1.0 + intmean)
    invrho = jnp.maximum(1.0 - rho, 1e-30)
    ent = -(invrho * jnp.log(invrho) + rho * jnp.log(rho)) * \
        np.float32(_INV_LOGE2) / rho
    ent = jnp.where(mabse < 1e-16, 0.0, ent)
    length = ent * n + LPC_COEFFICIENT_BITWIDTH * orders_ax[None, :]
    return (jnp.argmin(length, axis=1) + 1).astype(jnp.int32)


def _quantize(coefs: jnp.ndarray, orders: jnp.ndarray, nbits: int,
              max_bits: int):
    V, M = coefs.shape
    qmax = 1 << (nbits - 1)
    mask = jnp.arange(M)[None, :] < orders[:, None]
    maxabs = jnp.max(jnp.where(mask, jnp.abs(coefs), 0.0), axis=1)
    tiny = maxabs <= np.float32(2.0 ** (-(nbits - 1)))
    _, ndigit = jnp.frexp(jnp.maximum(maxabs, 1e-38))
    rshift = (nbits - 1) - ndigit
    rshift = jnp.where((rshift >= max_bits) | (rshift < 0), max_bits - 1,
                       rshift)
    rshift = jnp.where(tiny, nbits, rshift).astype(jnp.int32)
    scale = jnp.exp2(rshift.astype(jnp.float32))

    def body(i, carry):
        qerr, intc = carry
        ordi = M - 1 - i
        active = orders > ordi
        qe = qerr + coefs[:, ordi] * scale
        qt = jnp.clip(jnp.round(qe), -qmax, qmax - 1)
        qerr = jnp.where(active, qe - qt, qerr)
        intc = intc.at[:, ordi].set(jnp.where(active, qt.astype(jnp.int32), 0))
        return (qerr, intc)

    _, intc = jax.lax.fori_loop(
        0, M, body, (jnp.zeros(V, jnp.float32), jnp.zeros((V, M), jnp.int32)))
    intc = jnp.where(tiny[:, None], 0, intc)
    rshift = jnp.where(orders > 0, rshift, 0)
    return intc, rshift


def _reverse_coefs(intc: jnp.ndarray, orders: jnp.ndarray) -> jnp.ndarray:
    """rev[i] = c[order-1-i] for i < order, left-aligned."""
    V, M = intc.shape
    idx = orders[:, None] - 1 - jnp.arange(M)[None, :]
    return jnp.where(idx >= 0,
                     jnp.take_along_axis(intc, jnp.clip(idx, 0, M - 1),
                                         axis=1), 0)


def _predict(work: jnp.ndarray, coefs_rev: jnp.ndarray, orders: jnp.ndarray,
             rshifts: jnp.ndarray, n: int) -> jnp.ndarray:
    """Exact wrapping-int32 FIR residual (same math as dsp.predict)."""
    V, M = coefs_rev.shape
    j = jnp.arange(M)[None, :]
    cols = j - (M - orders)[:, None]
    aligned = jnp.where(cols >= 0,
                        jnp.take_along_axis(coefs_rev,
                                            jnp.clip(cols, 0, M - 1), axis=1),
                        0)
    padded = jnp.pad(work, ((0, 0), (M, 0)))
    half = jnp.where(rshifts > 0,
                     jnp.int32(1) << jnp.maximum(rshifts - 1, 0),
                     jnp.int32(-2147483648))

    def body(jj, acc):
        return acc + aligned[:, jj][:, None] * \
            jax.lax.dynamic_slice_in_dim(padded, jj, n, axis=1)

    acc = jax.lax.fori_loop(0, M, body,
                            jnp.zeros((V, n), jnp.int32) + half[:, None])
    pred = acc >> rshifts[:, None]
    full = work + pred
    first_diff = jnp.concatenate([work[:, :1], work[:, 1:] - work[:, :-1]],
                                 axis=1)
    s = jnp.arange(n)[None, :]
    o = orders[:, None]
    return jnp.where(o == 0, work,
                     jnp.where(s < o,
                               jnp.where(s == 0, work, first_diff), full))


def _zigzag(x: jnp.ndarray) -> jnp.ndarray:
    return ((-(x < 0).astype(jnp.int32)) ^ (x << 1)).astype(jnp.uint32)


def _ltp(work: jnp.ndarray, n: int, bps: int, fft_size: int, order: int):
    """Long-term (pitch) prediction, vectorized over variants (f32 fast path).

    Pitch selection follows the reference's rules (positive local maxima of
    the windowed autocorrelation in [min_period, max_period), 0.1*ac[0]
    energy threshold, first peak within 0.9 of the max) without the
    per-region candidate bracketing/20-candidate cap — parameter choices can
    differ from the exact host path on rare signals, which the tpu backend
    permits. The residual filter itself is exact wrapping int32, so every
    emitted block decodes losslessly. (Parity: libs/lpc/src/lpc.c:1473-1649.)
    """
    V = work.shape[0]
    max_lag = LTP_MAX_PERIOD + 1
    half_order = order // 2
    acl = _autocorr(work, n, bps, max_lag, fft_size)
    r0 = acl[:, 0]
    j = np.arange(max_lag)
    inrange = (j >= LTP_MIN_PERIOD) & (j < LTP_MAX_PERIOD)
    prev = jnp.concatenate([acl[:, :1], acl[:, :-1]], axis=1)
    nxt = jnp.concatenate([acl[:, 1:], acl[:, -1:]], axis=1)
    peak = ((acl > prev) & (acl > nxt) & (acl > 0)
            & jnp.asarray(inrange)[None, :])
    peakv = jnp.where(peak, acl, 0.0)
    max_peak = jnp.max(peakv, axis=1)
    cand = peak & (acl >= np.float32(0.9) * max_peak[:, None])
    period = jnp.argmax(cand, axis=1).astype(jnp.int32)  # first candidate
    valid = (jnp.any(peak, axis=1)
             & (max_peak >= np.float32(0.1) * r0)
             & (jnp.abs(r0) > np.float32(1e-35))
             & (period >= half_order + 1))

    ridge = np.float32(1.0 + LPC_RIDGE_REGULARIZATION_PARAMETER)
    r0r = r0 * ridge
    safe_p = jnp.maximum(period, half_order + 1)
    if order == 1:
        rhs0 = jnp.take_along_axis(acl, safe_p[:, None], axis=1)[:, 0]
        csol = (rhs0 / jnp.where(jnp.abs(r0r) < 1e-35, 1.0, r0r))[:, None]
    else:
        # Symmetric Toeplitz system A[j,k] = ac[|j-k|] (ridge on the diag).
        rows = []
        for jj in range(order):
            cols = [r0r if jj == kk else acl[:, abs(jj - kk)]
                    for kk in range(order)]
            rows.append(jnp.stack(cols, axis=1))
        A = jnp.stack(rows, axis=1)                       # (V, o, o)
        ridx = (safe_p[:, None] - half_order
                + jnp.arange(order, dtype=jnp.int32)[None, :])
        rhs = jnp.take_along_axis(acl, ridx, axis=1)      # (V, o)
        csol = jnp.linalg.solve(A, rhs[..., None])[..., 0]
    valid = valid & jnp.all(jnp.isfinite(csol), axis=1)

    q = jnp.where(csol >= 0, jnp.floor(csol * 32.0 + 0.5),
                  -jnp.floor(-csol * 32.0 + 0.5))
    q = jnp.clip(q, -32, 31).astype(jnp.int32)
    qrev = q[:, ::-1]                                     # reversed for FIR
    period = jnp.where(valid, period, 0)
    qrev = jnp.where(valid[:, None], qrev, 0)

    # Exact wrapping-int32 delay FIR (non-recursive on the encode side).
    rshift = LTP_COEFFICIENT_BITWIDTH - 1
    delay = period + half_order
    s = jnp.arange(n, dtype=jnp.int32)[None, :]
    acc = jnp.full((V, n), jnp.int32(1 << (rshift - 1)))
    for i in range(order):
        idx = jnp.clip(s - delay[:, None] + i, 0, n - 1)
        acc = acc + qrev[:, i][:, None] * jnp.take_along_axis(work, idx,
                                                              axis=1)
    pred = acc >> rshift
    apply = (period[:, None] > 0) & (s >= (delay + 1)[:, None])
    return jnp.where(apply, work - pred, work), period, qrev


def _rice_cost(residual: jnp.ndarray, n: int, max_porder: int):
    """Batched code-type + partition search. Static loop over partition
    orders; each evaluates every partition of every variant at once."""
    V = residual.shape[0]
    u = _zigzag(residual)
    uf = u.astype(jnp.float32)
    max_uval = jnp.max(u, axis=1)
    mean_all = jnp.sum(uf, axis=1) / n
    recursive = mean_all >= 2.0

    best_bits = jnp.full(V, jnp.int32(2 ** 30))
    best_porder = jnp.zeros(V, jnp.int32)
    MAXP = 1 << max_porder
    best_ks = jnp.zeros((V, MAXP), jnp.int32)

    for porder in range(max_porder + 1):
        nparts = 1 << porder
        nsmpl = n >> porder
        up = u.reshape(V, nparts, nsmpl).astype(jnp.int32)
        m = jnp.sum(uf.reshape(V, nparts, nsmpl), axis=2) / nsmpl
        # Recursive-Rice parameter (integer chain).
        g = jnp.maximum(1.0, np.float32(MLNOPTX) * (1.0 + m))
        k2 = jnp.clip(jnp.floor(jnp.log2(g)), 0, 30).astype(jnp.int32)
        k1pow = jnp.int32(1) << (k2 + 1)
        d = up - k1pow[:, :, None]
        rec_bits = jnp.sum(jnp.maximum(d, 0) >> k2[:, :, None], axis=2) \
            + (k2 + 2) * nsmpl
        # Plain-Rice parameter (f32 approximation of the libm chain).
        rho = 1.0 / (1.0 + m)
        om = jnp.maximum(1.0 - rho, 1e-30)
        lv = np.float32(-0.66794162356) / jnp.log(om)
        kf = jnp.round(jnp.log2(jnp.maximum(lv, 1e-30)))
        kr = jnp.clip(jnp.where(jnp.isfinite(kf), kf, 0.0), 0, 30).astype(
            jnp.int32)
        rice_bits = (jnp.sum(up >> kr[:, :, None], axis=2)
                     + (kr + 1) * nsmpl).astype(jnp.int32)
        ks = jnp.where(recursive[:, None], k2, kr)
        part_bits = jnp.where(recursive[:, None], rec_bits, rice_bits)
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
    return code_type, best_porder, bits, best_ks


def _analyze_core(sig: jnp.ndarray, *, n: int, bps: int, max_params: int,
                  max_fixed: bool, fft_size: int, max_porder: int,
                  ltp_order: int = 0):
    work, pre_coef = _preemphasis(sig)
    pre_prev = sig[:, 0]
    V = sig.shape[0]
    ltp_period = jnp.zeros(V, jnp.int32)
    ltp_coefs = jnp.zeros((V, max(ltp_order, 1)), jnp.int32)
    if ltp_order > 0 and fft_size >= LTP_MAX_PERIOD + 1:
        work, ltp_period, ltp_coefs = _ltp(work, n, bps, fft_size, ltp_order)
    if max_params > 0:
        ac = _autocorr(work, n, bps, max_params + 1, fft_size)
        ac = ac.at[:, 0].mul(
            np.float32(1.0 + LPC_RIDGE_REGULARIZATION_PARAMETER))
        ev, _ = _levinson(ac, max_params, None)
        orders = _select_order(ev, n, bps, max_params, max_fixed)
        _, coefs = _levinson(ac, max_params, orders)
        intc, rshifts = _quantize(coefs, orders, LPC_COEFFICIENT_BITWIDTH, 16)
        coefs_rev = _reverse_coefs(intc, orders)
        residual = _predict(work, coefs_rev, orders, rshifts, n)
    else:
        orders = jnp.zeros(V, jnp.int32)
        rshifts = jnp.zeros(V, jnp.int32)
        coefs_rev = jnp.zeros((V, 1), jnp.int32)
        residual = work
    code_type, best_porder, rice_bits, ks = _rice_cost(residual, n, max_porder)
    return dict(pre_prev=pre_prev, pre_coef=pre_coef, orders=orders,
                rshifts=rshifts, coefs=coefs_rev, residual=residual,
                code_type=code_type, porder=best_porder, rice_bits=rice_bits,
                ks=ks, ltp_period=ltp_period, ltp_coefs=ltp_coefs)


@partial(jax.jit, static_argnames=("n", "bps", "max_params", "max_fixed",
                                   "fft_size", "max_porder"))
def analyze_variants(sig: jnp.ndarray, *, n: int, bps: int, max_params: int,
                     max_fixed: bool, fft_size: int, max_porder: int):
    """Full analysis for a batch of channel-variants (residuals returned)."""
    return _analyze_core(sig, n=n, bps=bps, max_params=max_params,
                         max_fixed=max_fixed, fft_size=fft_size,
                         max_porder=max_porder)


@partial(jax.jit, static_argnames=("n", "bps", "max_params", "max_fixed",
                                   "fft_size", "max_porder", "W"))
def analyze_pack_variants(sig: jnp.ndarray, *, n: int, bps: int,
                          max_params: int, max_fixed: bool, fft_size: int,
                          max_porder: int, W: int):
    """Analysis + on-device residual-section packing (all variants).

    Returns (small, words): `small` holds per-variant parameters and exact
    section bit counts (cheap to fetch); `words` is the (V, W) packed residual
    sections, intended to stay on device until gather_sections.
    """
    from .bitpack import pack_residual_sections
    out = _analyze_core(sig, n=n, bps=bps, max_params=max_params,
                        max_fixed=max_fixed, fft_size=fft_size,
                        max_porder=max_porder)
    u = _zigzag(out["residual"])
    words, sec_bits, _ovf = pack_residual_sections(
        u, out["code_type"], out["porder"], out["ks"], n, W)
    small = {k: out[k] for k in ("pre_prev", "pre_coef", "orders", "rshifts",
                                 "coefs", "code_type", "porder", "rice_bits")}
    small["section_bits"] = sec_bits
    return small, words


@partial(jax.jit, static_argnames=("n", "bps", "max_params", "max_fixed",
                                   "fft_size", "max_porder", "C",
                                   "ltp_order"))
def analyze_blocks_ex(blocks: jnp.ndarray, lshift, *, n: int, bps: int,
                      max_params: int, max_fixed: bool, fft_size: int,
                      max_porder: int, C: int, ltp_order: int = 0):
    """Variant construction + analysis + exact section bit counts on device.

    blocks: (Bp, C, n) int32 raw PCM (bucket-padded). Builds the channel
    variants ([M, S] + plain channels, stacked on axis 0) on device so only
    the raw blocks cross the host link. The Rice search cost IS the exact
    emitted section size (integer bit counts for the chosen parameters), so
    no separate accounting pass is needed.

    Returns (small, big): `small` is fetched by the host (parameters + exact
    section bits for stereo selection / raw fallback); `big` stays on device
    and feeds pack_chosen.
    """
    work = blocks.astype(jnp.int32) >> lshift
    parts = []
    if C >= 2:
        s = work[:, 1] - work[:, 0]
        m = work[:, 0] + (s >> 1)
        parts.extend([m, s])
    parts.extend(work[:, c] for c in range(C))
    sig = jnp.concatenate(parts, axis=0)
    out = _analyze_core(sig, n=n, bps=bps, max_params=max_params,
                        max_fixed=max_fixed, fft_size=fft_size,
                        max_porder=max_porder, ltp_order=ltp_order)
    u = _zigzag(out["residual"])
    small = {k: out[k] for k in ("pre_prev", "pre_coef", "orders", "rshifts",
                                 "coefs", "code_type", "porder",
                                 "ltp_period", "ltp_coefs")}
    small["section_bits"] = out["rice_bits"]
    big = dict(u=u, code_type=out["code_type"], porder=out["porder"],
               ks=out["ks"])
    return small, big


@partial(jax.jit, static_argnames=("n", "W", "cap", "impl"))
def pack_chosen(u, code_type, porder, ks, chosen, starts, lens, *, n: int,
                W: int, cap: int, impl: str = "scatter"):
    """Pack ONLY the chosen variant rows and compact them into a flat word
    buffer in one device program (single fetch of ~compressed size).

    Returns (flat words (cap,), overflow (K,) bool) — overflow rows could
    not be packed (block impl frame limit) and must be host-encoded."""
    from .bitpack import pack_residual_sections
    uc = u[chosen]
    words, _, ovf = pack_residual_sections(uc, code_type[chosen],
                                           porder[chosen], ks[chosen], n, W,
                                           impl)
    j = jnp.arange(cap, dtype=jnp.int32)
    seg = jnp.clip(jnp.searchsorted(starts, j, side="right") - 1,
                   0, chosen.shape[0] - 1)
    col = j - starts[seg]
    ok = (col >= 0) & (col < lens[seg])
    col = jnp.clip(col, 0, W - 1)
    return jnp.where(ok, words[seg, col], 0), ovf


@partial(jax.jit, static_argnames=("cap",))
def gather_sections(words: jnp.ndarray, chosen: jnp.ndarray,
                    starts: jnp.ndarray, lens: jnp.ndarray, cap: int):
    """Compact chosen variants' packed sections into one flat word buffer.

    words: (V, W); chosen: (K,) variant rows in output order; starts: (K,)
    word offsets (cumsum of lens); lens: (K,) word counts. Returns (cap,)
    uint32 — fetch this (it is roughly the compressed size).
    """
    j = jnp.arange(cap, dtype=jnp.int32)
    seg = jnp.clip(jnp.searchsorted(starts, j, side="right") - 1,
                   0, chosen.shape[0] - 1)
    row = chosen[seg]
    col = j - starts[seg]
    ok = (col >= 0) & (col < lens[seg])
    col = jnp.clip(col, 0, words.shape[1] - 1)
    return jnp.where(ok, words[row, col], 0)
