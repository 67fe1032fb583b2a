"""Word-machine device decoder (kernels/decode2.py): unit and adversarial
coverage beyond the path-equivalence suite in test_decode_paths.py."""

import warnings

import numpy as np
import pytest

import signals
from srla_tpu import decode, encode
from srla_tpu.decoder import SRLADecoder


def test_sparse_payload_outliers():
    """A huge outlier in an otherwise near-silent block produces a unary run
    of thousands of zero bits (many completion-free payload words); the
    snapshot assembly has no window bound, so this decodes fully on device,
    bit-exact."""
    rng = np.random.RandomState(7)
    sig = (rng.randn(2, 4096 * 5) * 2).round().astype(np.int32)
    sig[0, 5000] = 30000          # forces a multi-thousand-bit unary run
    sig[1, 9000] = -30000
    sig[0, 17000] = 29000
    data = encode(sig, 16, 44100, preset=0)   # order 0: residual = signal
    _, host = decode(data)
    d = SRLADecoder(backend="tpu")
    _, dev = d.decode_whole(data)
    assert np.array_equal(dev, host)
    assert np.array_equal(dev, sig)
    assert d.stats["device_blocks"] >= 5, d.stats


def test_rolled_and_unrolled_machines_agree():
    """The fori_loop (CPU) and unrolled (GPU) bit-machine variants must be
    the same transducer."""
    import jax.numpy as jnp

    from srla_tpu.kernels.decode2 import _entropy_scan

    rng = np.random.RandomState(3)
    words = rng.randint(0, 2 ** 32, size=(40, 8),
                        dtype=np.uint64).astype(np.uint32)
    v1, m1, a1 = _entropy_scan(jnp.asarray(words), 128, 2, unroll_bits=False)
    v2, m2, a2 = _entropy_scan(jnp.asarray(words), 128, 2, unroll_bits=True)
    assert np.array_equal(np.asarray(v1), np.asarray(v2))
    assert np.array_equal(np.asarray(m1), np.asarray(m2))
    assert np.array_equal(np.asarray(a1), np.asarray(a2))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_decode_random_streams(seed):
    """Randomized differential decode across presets/LTP/stereo content."""
    rng = np.random.RandomState(seed)
    n = int(rng.randint(3 * 4096, 6 * 4096))
    kind = seed % 3
    if kind == 0:
        sig = (rng.randn(2, n) * 3000).astype(np.int32)
    elif kind == 1:
        sig = signals.pitchy(n, 2, 16)
    else:
        t = np.arange(n)
        sig = np.stack([
            (np.sin(t / 9.0) * 12000).astype(np.int32),
            (np.sin(t / 9.0 + 0.4) * 11000).astype(np.int32)])
    kw = [dict(), dict(ltp_order=3), dict(preset=6)][seed % 3]
    data = encode(sig, 16, 44100, **kw)
    _, host = decode(data)
    d = SRLADecoder(backend="tpu")
    _, dev = d.decode_whole(data)
    assert np.array_equal(dev, host)


def test_device_resident_verify():
    """decode_whole_device_resident verifies on device (one bool per group
    crosses the link) and covers host-path spans (raw/silent/tiny groups)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(9)
    sig = (rng.randn(2, 4096 * 4 + 100) * 4000).astype(np.int32)
    sig[:, 4096:8192] = 0                     # silent block
    data = encode(sig, 16, 44100)
    d = SRLADecoder(backend="tpu")
    ok, stats = d.decode_whole_device_resident(
        data, (jnp.asarray(sig), sig))
    assert ok, stats
    # A corrupted expectation must be detected.
    bad = sig.copy()
    bad[0, 10] ^= 1
    d = SRLADecoder(backend="tpu")
    ok2, _ = d.decode_whole_device_resident(data, (jnp.asarray(bad), bad))
    assert not ok2


def test_repair_rate_warning_fires():
    """The encoder warns (and records repair_ratio) when the boundary-flag
    repair rate exceeds the threshold; silent degradation is not allowed."""
    from srla_tpu.encoder import EncodeParameter, SRLAEncoder

    sig = signals.chirp(4096 * 4, 2, 16)
    param = EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=44100, preset=4,
        max_num_samples_per_block=4096, min_num_samples_per_block=4096,
        num_lookahead_samples=4 * 4096)
    enc = SRLAEncoder(param, backend="exact")
    enc.stats["device_blocks"] = 90
    enc.stats["repaired_blocks"] = 10
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        enc._check_repair_rate()
    assert enc.stats["repair_ratio"] == 0.1
    assert any("byte-exact" in str(w.message) for w in rec)
