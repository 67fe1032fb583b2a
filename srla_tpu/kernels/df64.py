"""Double-float (two-float32) arithmetic for near-f64 analysis on a device.

The device analysis runs in float32 (devices built for machine learning
have little or no float64 throughput). The bit-exact encode spec, however,
only needs f64 *decisions* (rounding of quantized coefficients, order argmins,
Rice-parameter boundaries...) — not f64 values. This module provides ~2^-48
relative-accuracy arithmetic built from pairs of float32 (hi, lo) with
|lo| <= ulp(hi)/2, so the device analysis can compute every decision quantity
accurately enough to *prove* (per value) that its decision matches the host's
f64 one — values too close to a decision boundary are flagged and re-derived
on the host (see kernels/exact.py).

All error-free transformations here avoid relying on FMA availability or
contraction behavior: two_prod uses a mantissa-masking Veltkamp split (each
factor is reduced to a 12-bit significand, making every partial product exact
in f32), and two_sum is the branch-free Knuth form (adds/subs only, immune to
contraction). This keeps results identical across XLA backends.

References: Dekker (1971), Knuth TAOCP v2, Hida/Li/Bailey's QD library
algorithms (public domain), adapted to f32 pairs.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

_MASK = np.int32(~0xFFF)  # keep 11 explicit mantissa bits (12-bit significand)


def _f32(x):
    return jnp.asarray(x, jnp.float32)


# -- FP-contraction defense --------------------------------------------------
#
# XLA:CPU's emitter contracts mul+add into FMA inside fusions, and XLA:GPU
# may do the same (observed on XLA:CPU with jaxlib 0.9, and neither
# optimization_barrier nor reduce_precision survives to block it). An FMA
# skips the product's rounding, which breaks every error-free transformation
# below that consumes a product in an add (s = p + e must see the ROUNDED p).
#
# Defense: "pin" every inexact product as `p = a*b + z` where z is a
# RUNTIME zero (derived from traced data, so no compiler can fold the add
# away). Even if the backend contracts this into fma(a, b, z), the result is
# round(a*b + 0) == round(a*b) — the pinned value is context-independent, so
# EFT invariants and cross-fusion value consistency both hold on every
# backend. Kernel entry points install the token via `pinned(...)`.

import threading

# Thread-LOCAL token store: the hybrid scheduler traces device programs from
# a worker thread while the main thread may be tracing span-measurement
# programs (-V). A process-global token would leak one trace's tracer into
# the other's (observed as UnexpectedTracerError on concurrent cold traces).
_PIN_TLS = threading.local()


class pinned:
    """Context manager installing a traced-zero pin token during tracing."""

    def __init__(self, traced_value):
        self._tok = jnp.asarray(traced_value, jnp.float32) * jnp.float32(0.0)

    def __enter__(self):
        self._prev = getattr(_PIN_TLS, "tok", None)
        _PIN_TLS.tok = self._tok
        return self

    def __exit__(self, *exc):
        _PIN_TLS.tok = self._prev
        return False


def _pin(x):
    tok = getattr(_PIN_TLS, "tok", None)
    return x if tok is None else x + tok


# A second XLA:CPU hazard (same root cause — real-arithmetic rewrites that
# are invalid in FP): constant reassociation. With a compile-time constant c
# as a TwoSum operand, `bb = (b + c) - c` is rewritten to `b`, destroying the
# error term. Constants entering dd chains therefore go through _pin too
# (runtime-valued, unfoldable); see const()/one_like().


def one_like(x):
    """Pinned runtime-valued (1.0, 0.0) pair broadcast like x."""
    return (_pin(jnp.ones_like(x)), _pin(jnp.zeros_like(x)))


# ---------------------------------------------------------------------------
# Error-free transformations
# ---------------------------------------------------------------------------

def two_sum(a, b):
    """s + err == a + b exactly (branch-free Knuth TwoSum; adds/subs only)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Requires |a| >= |b| (or a == 0). s + err == a + b exactly."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    """Veltkamp split via mantissa masking: a == hi + lo exactly, with both
    parts having <= 12-bit significands (products of two parts are exact in
    f32). Truncation-based, so no rounding-mode/contraction dependence."""
    bits = jax.lax.bitcast_convert_type(a, jnp.int32)
    hi = jax.lax.bitcast_convert_type(bits & _MASK, jnp.float32)
    return hi, a - hi


def two_prod(a, b):
    """p + err == a * b exactly (barring overflow/underflow-to-denormal).

    `p` is pinned (see the FP-contraction defense above). The split-half
    products in `err` are exact (<=12-bit significands), so FMA contraction
    cannot change them."""
    p = _pin(a * b)
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# ---------------------------------------------------------------------------
# Double-float ops. A df value is a tuple (hi, lo) of equal-shape f32 arrays.
# ---------------------------------------------------------------------------

def df(hi, lo=None):
    hi = _f32(hi)
    return (hi, jnp.zeros_like(hi) if lo is None else _f32(lo))


def add(x, y):
    """Accurate dd addition (Knuth): relative error <= 3 * 2^-48."""
    s1, s2 = two_sum(x[0], y[0])
    t1, t2 = two_sum(x[1], y[1])
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    return quick_two_sum(s1, s2)


def sub(x, y):
    return add(x, (-y[0], -y[1]))


def neg(x):
    return (-x[0], -x[1])


def mul(x, y):
    p, e = two_prod(x[0], y[0])
    # Each inexact correction product is pinned; all other mul->add sites in
    # this module involve exact products (split halves, powers of two,
    # integer-valued), where FMA contraction cannot change the result.
    corr = _pin(x[0] * y[1]) + _pin(x[1] * y[0])
    return quick_two_sum(p, e + corr)


def mul_pow2(x, p):
    """Multiply by an exact power of two (scalar float, exact)."""
    c = np.float32(p)
    return (x[0] * c, x[1] * c)


def div(x, y):
    q1 = x[0] / y[0]
    r = sub(x, mul(df(q1), y))
    q2 = r[0] / y[0]
    r = sub(r, mul(df(q2), y))
    q3 = r[0] / y[0]
    s, e = quick_two_sum(q1, q2)
    return add((s, e), df(q3))


def sqrt(x):
    """dd sqrt (one dd Newton step on the f32 estimate). x must be >= 0;
    returns 0 for x == 0."""
    s = jnp.sqrt(x[0])
    safe = jnp.where(s > 0, s, 1.0)
    # r = (x - s^2) / (2 s);  sqrt(x) ~= s + r
    s2 = two_prod(safe, safe)
    diff = sub(x, s2)
    r = diff[0] / (2.0 * safe)
    hi, lo = quick_two_sum(safe, r)
    zero = x[0] <= 0
    return (jnp.where(zero, 0.0, hi), jnp.where(zero, 0.0, lo))


def from_int32(x):
    """Exact df representation of int32 values (any magnitude)."""
    x = jnp.asarray(x, jnp.int32)
    hi_i = x & jnp.int32(~0xFF)
    lo_i = x & jnp.int32(0xFF)
    # |hi_i| <= 2^31 with 8 trailing zero bits -> <= 24-bit significand: exact.
    return quick_two_sum(hi_i.astype(jnp.float32), lo_i.astype(jnp.float32))


def to_f32(x):
    return x[0] + x[1]


# -- comparisons (lexicographic on the normalized pair) --------------------

def lt(x, y):
    return (x[0] < y[0]) | ((x[0] == y[0]) & (x[1] < y[1]))


def le(x, y):
    return (x[0] < y[0]) | ((x[0] == y[0]) & (x[1] <= y[1]))


def gt(x, y):
    return lt(y, x)


def ge(x, y):
    return le(y, x)


def abs_(x):
    flip = x[0] < 0
    return (jnp.where(flip, -x[0], x[0]), jnp.where(flip, -x[1], x[1]))


def floor(x):
    """dd floor. Exact when |x| < 2^31 (our use sites)."""
    fh = jnp.floor(x[0])
    hi_is_int = fh == x[0]
    fl = jnp.where(hi_is_int, jnp.floor(x[1]), 0.0)
    return quick_two_sum(fh, fl)


def round_half_away(x):
    """C round() semantics: round half away from zero, as a df value."""
    ax = abs_(x)
    r = floor(add(ax, (_pin(jnp.float32(0.5)), _pin(jnp.float32(0.0)))))
    s = jnp.where(x[0] < 0, -1.0, 1.0).astype(jnp.float32)
    return (r[0] * s, r[1] * s)


# ---------------------------------------------------------------------------
# Host-side helpers (numpy, f64)
# ---------------------------------------------------------------------------

def split_f64(x):
    """Split f64 numpy values into a (hi, lo) f32 pair (error < 2^-49 rel)."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def to_f64(x):
    """Recombine a fetched (hi, lo) pair into numpy f64."""
    return np.asarray(x[0], np.float64) + np.asarray(x[1], np.float64)


def const(v):
    """df constant from a Python float. Pinned to a runtime value when a pin
    token is installed, so no compile-time constant ever enters an EFT."""
    hi, lo = split_f64(np.float64(v))
    return (_pin(jnp.float32(hi)), _pin(jnp.float32(lo)))


# ---------------------------------------------------------------------------
# Natural log: gather-free atanh-series formulation (elementwise only, no
# table lookup).
#   x = m * 2^e with m in [sqrt(1/2), sqrt(2));  t = (m-1)/(m+1), |t|<=0.1716;
#   ln x = e*ln2 + 2t*(1 + t^2/3 + t^4/5 + ... + t^18/19).
# Accuracy ~1e-13 relative (validated in tests/test_df64.py).
# ---------------------------------------------------------------------------

_LN2 = split_f64(np.float64(math.log(2.0)))
_SQRT_HALF = np.float32(0.7071067811865476)


def log(x):
    """dd natural log. Domain: x > 0 (finite); returns garbage outside —
    callers gate/flag non-positive inputs themselves."""
    m_hi, e = jnp.frexp(jnp.maximum(x[0], np.float32(1e-38)))
    scale = jnp.exp2(-e.astype(jnp.float32))
    m = (m_hi, x[1] * scale)  # exact scaling by 2^-e
    # Fold m into [sqrt(1/2), sqrt(2)) so |t| <= 0.1716 (doubling is exact).
    low = m[0] < _SQRT_HALF
    m = (jnp.where(low, m[0] * 2.0, m[0]), jnp.where(low, m[1] * 2.0, m[1]))
    e = e - low.astype(e.dtype)
    one = (_pin(jnp.float32(1.0)), _pin(jnp.float32(0.0)))
    t = div(sub(m, one), add(m, one))
    u = mul(t, t)
    acc = const(1.0 / 19.0)
    for c in (1.0 / 17.0, 1.0 / 15.0, 1.0 / 13.0, 1.0 / 11.0, 1.0 / 9.0,
              1.0 / 7.0, 1.0 / 5.0, 1.0 / 3.0, 1.0):
        acc = add(mul(acc, u), const(c))
    ln_m = mul(mul_pow2(t, 2.0), acc)
    e_dd = (e.astype(jnp.float32), jnp.zeros_like(m_hi))
    ln2 = (_pin(jnp.full_like(m_hi, _LN2[0])), _pin(jnp.full_like(m_hi,
                                                                  _LN2[1])))
    return add(mul(e_dd, ln2), ln_m)


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------

def sum_pairwise(x, axis=-1):
    """dd sum along `axis` by pairwise (tree) folding. Length is padded to a
    power of two with zeros; error grows as log2(n) * 2^-48 relative."""
    hi = jnp.moveaxis(x[0], axis, -1)
    lo = jnp.moveaxis(x[1], axis, -1)
    n = hi.shape[-1]
    p = 1
    while p < n:
        p *= 2
    if p != n:
        pad = [(0, 0)] * (hi.ndim - 1) + [(0, p - n)]
        hi = jnp.pad(hi, pad)
        lo = jnp.pad(lo, pad)
    while p > 1:
        p //= 2
        a = (hi[..., :p], lo[..., :p])
        b = (hi[..., p:], lo[..., p:])
        hi, lo = add(a, b)
    return (hi[..., 0], lo[..., 0])
