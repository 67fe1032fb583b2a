"""LPC-synthesis kernel (kernels/pallas_lpc.py) vs the XLA scan.

The kernel is compiled for the GPU through Pallas's Triton route; here it
runs in interpret mode on the CPU, which pins its integer semantics
(wrapping int32, warm-up ramp, rshift-0 INT_MIN half, fused de-emphasis,
row and sample padding) against kernels/decode2._lpc_scan. `chip_smoke.py`
runs the compiled kernel against the same reference on the card."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from srla_tpu.kernels import decode2  # noqa: E402
from srla_tpu.kernels.decode2 import _align_coefs, _lpc_scan  # noqa: E402
from srla_tpu.kernels.pallas_lpc import (lpc_synthesis,  # noqa: E402
                                         samples_per_trip)


def _mk(R, n, M, seed, big=False):
    rng = np.random.RandomState(seed)
    res = rng.randint(-(1 << 30) if big else -4000,
                      (1 << 30) if big else 4000, (R, n)).astype(np.int32)
    orders = rng.randint(0, M + 1, R).astype(np.int32)
    orders[0] = 0                       # inactive row passes through
    if R > 2:
        orders[2] = M                   # full-order row
    coefs = rng.randint(-(1 << 15), 1 << 15, (R, M)).astype(np.int32)
    rshifts = rng.randint(0, 15, R).astype(np.int32)
    rshifts[1 % R] = 0                  # the INT_MIN-half quirk row
    aligned = np.asarray(_align_coefs(jnp.asarray(coefs),
                                      jnp.asarray(orders), M))
    return res, aligned, orders, rshifts


def _deemph(R, seed=99):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 16, R).astype(np.int32),
            rng.randint(-30000, 30000, R).astype(np.int32))


def _scan(res, aligned, orders, rshifts, n, M, dcoef=None, dprev=None):
    kw = {}
    if dcoef is not None:
        kw = dict(dcoef=jnp.asarray(dcoef), dprev=jnp.asarray(dprev))
    return np.asarray(_lpc_scan(jnp.asarray(res), jnp.asarray(aligned),
                                jnp.asarray(orders), jnp.asarray(rshifts),
                                n, M, **kw))


@pytest.mark.parametrize("R,n,M", [(3, 64, 8), (130, 33, 16), (128, 64, 8)])
def test_matches_xla_scan(R, n, M):
    res, aligned, orders, rshifts = _mk(R, n, M, seed=R + n)
    want = _scan(res, aligned, orders, rshifts, n, M)
    got = np.asarray(lpc_synthesis(res, aligned, orders, rshifts, n, M,
                                   interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("R,n,M", [(5, 48, 8), (129, 40, 16)])
def test_matches_xla_scan_fused_deemph(R, n, M):
    res, aligned, orders, rshifts = _mk(R, n, M, seed=7 * R + n)
    dcoef, dprev = _deemph(R)
    want = _scan(res, aligned, orders, rshifts, n, M, dcoef, dprev)
    got = np.asarray(lpc_synthesis(res, aligned, orders, rshifts, n, M,
                                   dcoef=dcoef, dprev=dprev,
                                   interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("R,n,M,rows", [
    (70, 96, 16, 16),     # a row tile that does not divide R
    (40, 50, 256, 32),    # the widest order: K drops to 4 samples per trip
])
def test_row_tile_and_wide_order(R, n, M, rows):
    res, aligned, orders, rshifts = _mk(R, n, M, seed=3)
    dcoef, dprev = _deemph(R, seed=11)
    want = _scan(res, aligned, orders, rshifts, n, M, dcoef, dprev)
    got = np.asarray(lpc_synthesis(res, aligned, orders, rshifts, n, M,
                                   dcoef=dcoef, dprev=dprev, rows=rows,
                                   interpret=True))
    np.testing.assert_array_equal(got, want)


def test_wrapping_int32_semantics():
    # Large residuals/coefs force int32 overflow in the window dot — both
    # paths must wrap identically (two's complement), not saturate.
    res, aligned, orders, rshifts = _mk(4, 32, 8, seed=5, big=True)
    want = _scan(res, aligned, orders, rshifts, 32, 8)
    got = np.asarray(lpc_synthesis(res, aligned, orders, rshifts, 32, 8,
                                   interpret=True))
    np.testing.assert_array_equal(got, want)


def test_body_bound_and_row_tile_check():
    assert [samples_per_trip(M) for M in (1, 8, 64, 72, 128, 256)] == \
        [16, 16, 16, 14, 8, 4]
    res, aligned, orders, rshifts = _mk(4, 16, 8, seed=1)
    with pytest.raises(ValueError, match="power of two"):
        lpc_synthesis(res, aligned, orders, rshifts, 16, 8, rows=24,
                      interpret=True)


def test_ltp_deemphasis_through_kernel():
    """With LTP the de-emphasis runs as its own recurrence; the kernel path
    (order-0 recurrence with fused de-emphasis) must equal the scan path."""
    B, C, n, M = 3, 2, 64, 8
    R = B * C
    rng = np.random.RandomState(21)
    res, aligned, orders, rshifts = _mk(R, n, M, seed=21)
    coefs = np.zeros((R, M), np.int32)
    for r in range(R):      # back from right-aligned to emitted order
        o = int(orders[r])
        coefs[r, :o] = aligned[r, M - o:]
    dcoef, dprev = _deemph(R, seed=22)
    ltp_orders = np.full((B, C), 3, np.int32)
    ltp_periods = rng.randint(20, 40, (B, C)).astype(np.int32)
    ltp_coefs = rng.randint(-4000, 4000, (B, C, 3)).astype(np.int32)
    methods = np.array([0, 1, 2], np.int32)
    args = [jnp.asarray(a) for a in (
        res.reshape(B, C, n), orders.reshape(B, C), rshifts.reshape(B, C),
        coefs.reshape(B, C, M), ltp_orders, ltp_periods, ltp_coefs,
        dcoef.reshape(B, C), dprev.reshape(B, C), methods)]
    outs = [np.asarray(decode2._synthesize(
        *args, np.int32(0), n=n, C=C, M=M, has_ltp=True, lpc_impl=impl))
        for impl in ("scan", "interpret")]
    np.testing.assert_array_equal(outs[1], outs[0])


def test_kernel_per_shard_under_mesh():
    """Under a mesh the kernel runs per shard of the row axis (shard_map);
    the result must equal the unsharded scan."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    devs = jax.devices()[:4]
    if len(devs) < 4:
        pytest.skip("needs 4 devices (the suite runs an 8-device CPU mesh)")
    mesh = Mesh(np.array(devs), ("blocks",))
    R, n, M = 16, 40, 8
    res, aligned, orders, rshifts = _mk(R, n, M, seed=31)
    dcoef, dprev = _deemph(R, seed=32)
    want = _scan(res, aligned, orders, rshifts, n, M, dcoef, dprev)
    row = NamedSharding(mesh, P("blocks"))
    mat = NamedSharding(mesh, P("blocks", None))
    got = jax.jit(lambda r, a, o, s, dc, dp: decode2._lpc(
        r, a, o, s, n, M, dc, dp, impl="interpret", mesh=mesh))(
        jax.device_put(res, mat), jax.device_put(aligned, mat),
        jax.device_put(orders, row), jax.device_put(rshifts, row),
        jax.device_put(dcoef, row), jax.device_put(dprev, row))
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs the compiled kernel")


@pytest.mark.gpu
def test_compiled_kernel_matches_scan(gpu):
    res, aligned, orders, rshifts = _mk(300, 4096, 64, seed=41)
    dcoef, dprev = _deemph(300, seed=42)
    want = _scan(res, aligned, orders, rshifts, 4096, 64, dcoef, dprev)
    got = np.asarray(lpc_synthesis(res, aligned, orders, rshifts, 4096, 64,
                                   dcoef=dcoef, dprev=dprev))
    np.testing.assert_array_equal(got, want)
