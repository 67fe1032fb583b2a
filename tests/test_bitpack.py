"""Device bit-packing kernels vs the host emitter (CPU backend / interpret)."""

import numpy as np
import pytest

from srla_tpu import rice
from srla_tpu.bitio import BitWriter, sint32_to_uint32


def _cases(n):
    rng = np.random.RandomState(0)
    return np.stack([
        rng.randint(-3000, 3000, size=n),
        rng.randint(-2, 2, size=n),
        np.zeros(n, dtype=int),
        (rng.randn(n) * np.where(np.arange(n) < n // 2, 5, 2000)).astype(int),
        rng.randint(-30000, 30000, size=n),
        rng.randint(-8_000_000, 8_000_000, size=n),
    ]).astype(np.int32)


@pytest.mark.parametrize("impl", ["scatter", "prefix", "block"])
def test_device_pack_matches_host_emitter(impl):
    import jax.numpy as jnp

    from srla_tpu.kernels.bitpack import pack_residual_sections
    n = 4096
    res = _cases(n)
    ct, po, bits, ks = rice.analyze_batch(res, n)
    uvals = sint32_to_uint32(res.astype(np.int32)).astype(np.int64)
    W = 4096 * 30 // 32
    words, total, ovf = pack_residual_sections(
        jnp.asarray(uvals.astype(np.uint32)), jnp.asarray(ct),
        jnp.asarray(po), jnp.asarray(ks.astype(np.int32)), n, W, impl)
    words = np.asarray(words)
    total = np.asarray(total)
    ovf = np.asarray(ovf)
    for v in range(res.shape[0]):
        if ovf[v]:
            continue  # block impl may punt pathological rows — never wrong
        w = BitWriter()
        rice.emit_channel(w, uvals[v], n, int(ct[v]), int(po[v]), ks[v])
        ref = w.getvalue()
        assert int(total[v]) == w.tell_bits()
        assert words[v].astype(">u4").tobytes()[:len(ref)] == ref
    assert ovf.sum() <= 1  # only the adversarial wide-range case may punt


def test_block_pack_overflow_flagging():
    """A pathological codeword run must flag, never corrupt."""
    import jax.numpy as jnp

    from srla_tpu.kernels.bitpack import pack_residual_sections
    n = 256
    res = np.zeros((2, n), np.int32)
    res[0] = 3          # benign row
    res[1, ::16] = 1 << 22  # huge outliers -> enormous unary runs at small k
    ct, po, bits, ks = rice.analyze_batch(res, n)
    uvals = sint32_to_uint32(res).astype(np.uint32)
    W = int(bits.max() // 32 + 64)
    words, total, ovf = pack_residual_sections(
        jnp.asarray(uvals), jnp.asarray(ct), jnp.asarray(po),
        jnp.asarray(ks.astype(np.int32)), n, W, "block")
    ovf = np.asarray(ovf)
    assert not ovf[0]
    w = BitWriter()
    rice.emit_channel(w, uvals[0].astype(np.int64), n, int(ct[0]),
                      int(po[0]), ks[0])
    ref = w.getvalue()
    assert np.asarray(words)[0].astype(">u4").tobytes()[:len(ref)] == ref


def test_pack_flat_stream_matches_scatter_compaction():
    """The absolute-offset grouped-window pack (impl="flat") must emit the
    same compacted flat stream as the per-row scatter pack + row compaction
    it replaced (parity: both are fed the same residual_codewords stream)."""
    import jax.numpy as jnp

    from srla_tpu.kernels.bitpack import (pack_flat_stream,
                                          pack_residual_sections,
                                          residual_codewords)
    rng = np.random.RandomState(7)
    n, K = 1024, 12
    res = (rng.laplace(0, 18, size=(K, n))).astype(np.int32)
    res[3] = 0                                    # allzero section
    res[5] = (rng.laplace(0, 40000, size=n)).astype(np.int32)  # recursive
    ct, po, bits, ks = rice.analyze_batch(res, n)
    u = jnp.asarray(sint32_to_uint32(res).astype(np.uint32))
    ct, po = jnp.asarray(ct), jnp.asarray(po)
    ks = jnp.asarray(ks.astype(np.int32))
    W = int(np.asarray(bits).max() // 32 + 8)
    sec = jnp.asarray(bits.astype(np.int32))
    skip = np.zeros(K, bool)
    skip[4] = True                                # a host-repair row
    lens_w = jnp.where(jnp.asarray(skip), 0, (sec + 31) // 32)
    csum = jnp.cumsum(lens_w)
    starts = (csum - lens_w).astype(jnp.int32)
    cap = K * W

    # Old path: per-row pack + searchsorted compaction.
    words, _, _ = pack_residual_sections(u, ct, po, ks, n, W, "scatter")
    j = jnp.arange(cap, dtype=jnp.int32)
    seg = jnp.clip(jnp.searchsorted(starts, j, side="right") - 1, 0, K - 1)
    col = j - starts[seg]
    ok = (col >= 0) & (col < lens_w[seg])
    want = np.asarray(jnp.where(ok, words[seg, jnp.clip(col, 0, W - 1)], 0))

    # New path: absolute offsets, one flat grouped-window pass.
    (offs, tails, tbits), _tot = residual_codewords(u, ct, po, ks, n)
    offs = jnp.where(jnp.asarray(skip)[:, None], 0, offs) \
        + starts[:, None] * 32
    tbits = jnp.where(jnp.asarray(skip)[:, None], 0, tbits)
    G = 64
    padT = (-offs.shape[1]) % G
    if padT:
        endo = offs[:, -1:] + tbits[:, -1:]
        offs = jnp.concatenate(
            [offs, jnp.broadcast_to(endo, (K, padT))], axis=1)
        tails = jnp.pad(tails, ((0, 0), (0, padT)))
        tbits = jnp.pad(tbits, ((0, 0), (0, padT)))
    flat, g_ovf = pack_flat_stream(offs, tails, tbits, cap, G=G)
    assert not np.asarray(g_ovf).any()
    total = int(np.asarray(lens_w).sum())
    np.testing.assert_array_equal(np.asarray(flat)[:total], want[:total])


def test_pack_flat_stream_group_overflow_flagged():
    """A >2A-word span inside one 64-entry group (possible only with
    hostile/corrupt partition parameters, never from the optimal search)
    must set that group's overflow flag and leave other rows' words
    intact rather than corrupting silently."""
    import jax.numpy as jnp

    from srla_tpu.kernels.bitpack import pack_flat_stream
    G = 64
    R, T = 2, G
    offs = np.zeros((R, T), np.int64)
    tails = np.ones((R, T), np.uint32)
    tbits = np.ones((R, T), np.int32)
    # Row 0: entry 1 jumps 9000 bits ahead (a giant unary run) => its group
    # frame (2*64 words = 4096 bits) cannot hold both ends.
    offs[0] = 9000 + np.arange(T)
    offs[0, 0] = 0
    # Row 1: a normal tight section starting at word 300.
    offs[1] = 300 * 32 + np.arange(T)
    flat, ovf = pack_flat_stream(jnp.asarray(offs), jnp.asarray(tails),
                                 jnp.asarray(tbits), 400, G=G)
    ovf = np.asarray(ovf)
    assert ovf[0].any() and not ovf[1].any()
    # Row 1's words decode exactly: 64 consecutive 1-bits from bit 9600.
    w = np.asarray(flat)
    assert w[300] == 0xFFFFFFFF and w[301] == 0xFFFFFFFF
