"""Accuracy/exactness tests for the double-float (two-f32) device arithmetic.

These bounds are what the exact-device-encode design leans on: every decision
margin in kernels/exact.py assumes |df64(value) - f64(value)| is far below the
flag threshold. Runs on whatever JAX backend is active (CPU in CI;
chip_smoke.py runs the error-free transforms on the GPU).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from srla_tpu.kernels import df64  # noqa: E402

RNG = np.random.default_rng(1234)


def _rand(n, lo=-1e6, hi=1e6):
    # Mixed-magnitude f64 values (exercise exponent range).
    mag = RNG.uniform(-30, 30, n)
    sign = RNG.choice([-1.0, 1.0], n)
    return sign * np.exp(mag) * RNG.uniform(0.5, 2.0, n)


def _pair(x):
    hi, lo = df64.split_f64(x)
    return (jnp.asarray(hi), jnp.asarray(lo))


def _back(p):
    return df64.to_f64((np.asarray(p[0]), np.asarray(p[1])))


def test_two_prod_exact():
    a = np.asarray(RNG.uniform(-1e6, 1e6, 4096), np.float32)
    b = np.asarray(RNG.uniform(-1e6, 1e6, 4096), np.float32)
    p, e = df64.two_prod(jnp.asarray(a), jnp.asarray(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    assert (got == exact).all()


def test_two_sum_exact():
    a = np.asarray(RNG.uniform(-1e8, 1e8, 4096), np.float32)
    b = np.asarray(RNG.uniform(-1e-3, 1e-3, 4096), np.float32)
    s, e = df64.two_sum(jnp.asarray(a), jnp.asarray(b))
    exact = a.astype(np.float64) + b.astype(np.float64)
    got = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    assert (got == exact).all()


def test_from_int32_exact():
    x = RNG.integers(-(2**31), 2**31, 8192, dtype=np.int32)
    p = df64.from_int32(jnp.asarray(x))
    got = _back(p)
    assert (got == x.astype(np.float64)).all()


@pytest.mark.parametrize("op,npop", [
    ("add", np.add), ("sub", np.subtract), ("mul", np.multiply),
    ("div", np.divide),
])
def test_arith_accuracy(op, npop):
    x = _rand(4096)
    y = _rand(4096)
    got = _back(getattr(df64, op)(_pair(x), _pair(y)))
    want = npop(x, y)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    # split_f64 representation error is ~2^-49 per operand; ops add ~2^-47.
    assert rel.max() < 1e-12, rel.max()


def test_sqrt_accuracy():
    x = np.abs(_rand(4096))
    got = _back(df64.sqrt(_pair(x)))
    rel = np.abs(got - np.sqrt(x)) / np.sqrt(x)
    assert rel.max() < 1e-12
    z = df64.sqrt(_pair(np.zeros(4)))
    assert (_back(z) == 0).all()


def test_log_accuracy():
    x = np.abs(_rand(8192))
    got = _back(df64.log(_pair(x)))
    want = np.log(x)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max() < 1e-12, err.max()
    # Near 1 (small |log|): absolute accuracy matters for boundary margins.
    x = 1.0 + RNG.uniform(-0.4, 0.9, 4096)
    got = _back(df64.log(_pair(x)))
    assert np.abs(got - np.log(x)).max() < 1e-12


def test_floor_round():
    x = np.concatenate([
        _rand(2048, -1e4, 1e4) % 1000.0,
        np.array([0.0, 1.0, -1.0, 2.5, -2.5, 3.49999, -3.49999, 1e7 + 0.5]),
    ])
    fl = _back(df64.floor(_pair(x)))
    assert (fl == np.floor(x)).all()
    r = _back(df64.round_half_away(_pair(x)))
    want = np.where(x >= 0, np.floor(x + 0.5), -np.floor(-x + 0.5))
    assert (r == want).all()


def test_sum_pairwise():
    x = RNG.uniform(-1.0, 1.0, (8, 4097))
    got = _back(df64.sum_pairwise(_pair(x), axis=-1))
    want = np.asarray([np.sum(row) for row in x])  # f64 pairwise-ish
    assert np.abs(got - want).max() < 1e-11 * np.abs(want).max() + 1e-13


def test_sum_pairwise_exact_ints():
    # Integer inputs below 2^48 total: the tree sum is exact.
    x = RNG.integers(0, 2**30, (4, 1024)).astype(np.float64)
    got = _back(df64.sum_pairwise(_pair(x), axis=-1))
    want = x.sum(axis=-1)
    assert (got == want).all()


def test_comparisons():
    a = _pair(np.array([1.0, 1.0, 2.0]))
    b = df64.add(_pair(np.array([1.0, 1.0, 2.0])),
                 _pair(np.array([1e-13, -1e-13, 0.0])))
    assert list(np.asarray(df64.lt(a, b))) == [True, False, False]
    assert list(np.asarray(df64.le(a, b))) == [True, False, True]


def test_pin_token_is_thread_local():
    """The hybrid scheduler traces device programs from a worker thread
    while the main thread traces -V span-measurement programs; one trace's
    pin token must never leak into the other (UnexpectedTracerError on
    concurrent cold traces with a process-global token)."""
    import threading

    import jax.numpy as jnp

    ready = threading.Event()
    done = threading.Event()

    def holder():
        with df64.pinned(jnp.float32(1.0)):
            ready.set()
            done.wait(10)

    t = threading.Thread(target=holder)
    t.start()
    assert ready.wait(10)
    try:
        x = jnp.float32(2.0)
        # This thread holds no token: _pin must be the identity here even
        # while the other thread's context is active.
        assert df64._pin(x) is x
    finally:
        done.set()
        t.join()
