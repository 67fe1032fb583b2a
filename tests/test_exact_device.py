"""Differential test: exact-device analysis (df64 + boundary flags) vs the
bit-exact host pipeline.

Every UNFLAGGED variant must make byte-identical decisions (pre-emphasis
coefficient, LPC order, quantized coefficients + shift, residual, Rice code
type / partition order / parameters, section bits). Flag rates must stay low
(flagged blocks are host-re-derived at encode time, so they cost performance,
not correctness).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from srla_tpu import rice  # noqa: E402
from srla_tpu.constants import PARAMETER_PRESETS  # noqa: E402
from srla_tpu.encoder import EncodeParameter, SRLAEncoder  # noqa: E402
from srla_tpu.kernels.exact import analyze_blocks_exact  # noqa: E402

RNG = np.random.default_rng(42)


def _signals(B, n, bps):
    amp = (1 << (bps - 1)) - 1
    sigs = []
    t = np.arange(n)
    for b in range(B):
        kind = b % 8
        if kind == 0:
            s = RNG.normal(0, amp * 0.3, n)
        elif kind == 1:
            s = amp * 0.8 * np.sin(2 * np.pi * t * (b + 1) * 440.0 / 48000)
        elif kind == 2:
            s = RNG.normal(0, amp * 2e-4, n)  # quiet noise
        elif kind == 3:
            s = np.zeros(n)  # silence
        elif kind == 4:
            s = np.zeros(n)
            s[n // 3] = amp  # impulse
        elif kind == 5:
            s = np.full(n, max(1, int(amp * 0.01)))  # DC
        elif kind == 6:
            s = amp * 0.5 * np.sin(2 * np.pi * t * 0.45)  # near-Nyquist
        else:
            s = (RNG.normal(0, amp * 0.2, n)
                 + amp * 0.6 * np.sin(2 * np.pi * t * 220.0 / 44100))
        sigs.append(np.clip(s, -amp - 1, amp))
    return np.asarray(sigs, np.int32)


def _max_porder(n):
    p = 1
    while n % (1 << p) == 0:
        p += 1
    return min(p - 1, 10)


@pytest.mark.parametrize("bps,preset,n", [
    (16, 4, 1024), (16, 2, 4096), (24, 4, 1024), (16, 6, 512),
    (16, 4, 96), (16, 0, 1024),
])
def test_exact_device_matches_host(bps, preset, n):
    B = 16
    C = 2
    blocks = np.stack([_signals(B, n, bps),
                       _signals(B, n, bps)], axis=1)  # (B, C, n)
    param = EncodeParameter(
        num_channels=C, bits_per_sample=bps, sampling_rate=44100,
        min_num_samples_per_block=n, max_num_samples_per_block=n,
        num_lookahead_samples=n, preset=preset)
    enc = SRLAEncoder(param, backend="exact")
    pre = PARAMETER_PRESETS[preset]
    from srla_tpu.dsp.fft import round_up_pow2
    fft_size = round_up_pow2(n)

    small, big = analyze_blocks_exact(
        blocks, np.int32(0), n=n, bps=bps,
        max_params=pre.max_num_parameters,
        max_fixed=(pre.lpc_order_tactics == 0), fft_size=fft_size,
        max_porder=_max_porder(n), C=C)
    small = jax.device_get(small)
    big = jax.device_get(big)

    # Host oracle over the same variant stack ([M, S, ch0, ch1]).
    s = (blocks[:, 1] - blocks[:, 0]).astype(np.int32)
    m = (blocks[:, 0] + (s >> 1)).astype(np.int32)
    stack = np.concatenate([m, s, blocks[:, 0], blocks[:, 1]], axis=0)
    host = enc._analyze_channel(stack.copy(), n)

    risky = np.asarray(small["risky"])
    ok = ~risky
    frac = risky.mean()
    assert frac < 0.25, f"flag rate too high: {frac}"

    np.testing.assert_array_equal(small["pre_coef"][ok],
                                  host.pre_coef[ok])
    np.testing.assert_array_equal(small["orders"][ok], host.lpc_order[ok])
    np.testing.assert_array_equal(small["rshifts"][ok], host.lpc_rshift[ok])
    maxp = max(pre.max_num_parameters, 1)
    np.testing.assert_array_equal(small["coefs"][ok][:, :maxp],
                                  host.lpc_coefs[ok][:, :maxp])
    np.testing.assert_array_equal(small["code_type"][ok],
                                  host.rice_type[ok])
    np.testing.assert_array_equal(small["porder"][ok],
                                  host.rice_porder[ok])
    nk = min(big["ks"].shape[1], host.rice_ks.shape[1])
    np.testing.assert_array_equal(big["ks"][ok][:, :nk],
                                  host.rice_ks[ok][:, :nk].astype(np.int32))
    # Section bits: recompute the host residual's exact section size.
    _, _, host_bits, _ = rice.analyze_batch(host.residual[:, :n], n)
    np.testing.assert_array_equal(small["section_bits"][ok], host_bits[ok])
    # Residuals (zigzagged on device).
    from srla_tpu.bitio import sint32_to_uint32
    np.testing.assert_array_equal(big["u"][ok],
                                  sint32_to_uint32(host.residual[ok, :n]))


def test_flag_rate_on_music_like():
    """Realistic content should flag (almost) nothing."""
    bps, n, B, C = 16, 4096, 32, 2
    t = np.arange(B * n) / 44100.0
    base = (8000 * np.sin(2 * np.pi * 220 * t)
            + 4000 * np.sin(2 * np.pi * 331 * t + 0.3)
            + RNG.normal(0, 500, B * n))
    l = np.clip(base, -32768, 32767).astype(np.int32)
    r = np.clip(base * 0.8 + RNG.normal(0, 300, B * n), -32768,
                32767).astype(np.int32)
    blocks = np.stack([l.reshape(B, n), r.reshape(B, n)], axis=1)
    pre = PARAMETER_PRESETS[4]
    small, _ = analyze_blocks_exact(
        blocks, np.int32(0), n=n, bps=bps,
        max_params=pre.max_num_parameters, max_fixed=False, fft_size=n,
        max_porder=_max_porder(n), C=C)
    risky = np.asarray(jax.device_get(small["risky"]))
    assert risky.mean() <= 0.02, f"music flag rate {risky.mean()}"


def test_flat_pack_impl_stream_identical(monkeypatch):
    """The flat pack (absolute-offset grouped-window,
    kernels/bitpack.py pack_flat_stream) must emit byte-identical streams
    to the scatter pack through the full fused-encode wiring (selection,
    skip rows, raw fallbacks). Small shape: the flat frame loop costs real
    XLA:CPU compile time."""
    import signals
    from srla_tpu import encode

    pcm = signals.ALL["white_noise"](4096, 2, 16)
    monkeypatch.setenv("SRLA_PACK_IMPL", "scatter")
    want = encode(pcm, 16, 44100, preset=2, max_block=1024, backend="tpu")
    monkeypatch.setenv("SRLA_PACK_IMPL", "flat")
    got = encode(pcm, 16, 44100, preset=2, max_block=1024, backend="tpu")
    assert got == want


def test_min_group_threshold_is_policy_not_capability(monkeypatch):
    """The device pipeline handles ANY group size: with the row thresholds
    forced to 1, a single-block file must encode AND decode through the
    device path (no host routing) and stay byte-exact vs the exact host
    stream. The default thresholds are a latency policy for straggler
    blocks."""
    import signals
    from srla_tpu import encode
    from srla_tpu.decoder import SRLADecoder
    from srla_tpu.encoder import EncodeParameter, SRLAEncoder

    pcm = signals.ALL["sine"](4096, 2, 16)          # exactly one block
    want = encode(pcm, 16, 44100, preset=2, backend="exact")
    monkeypatch.setenv("SRLA_TPU_MIN_GROUP_ROWS", "1")
    monkeypatch.setenv("SRLA_TPU_HOST_SHARE", "0")
    param = EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=44100, preset=2,
        max_num_samples_per_block=4096, min_num_samples_per_block=4096,
        num_lookahead_samples=4 * 4096)
    enc = SRLAEncoder(param, backend="tpu")
    got = enc.encode_whole(pcm)
    assert got == want
    assert enc.stats["device_blocks"] == 1, enc.stats
    assert enc.stats["host_blocks"] == 0, enc.stats

    monkeypatch.setenv("SRLA_DEV_MIN_GROUP", "1")
    dec = SRLADecoder(backend="tpu")
    _, out = dec.decode_whole(got)
    assert np.array_equal(out, pcm)
    assert dec.stats["device_blocks"] == 1, dec.stats
    assert dec.stats["host_blocks"] == 0, dec.stats
