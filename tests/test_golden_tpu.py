"""Golden byte-exactness of the DEVICE (tpu) backend.

The exact device mode (kernels/exact.py) must emit byte-identical streams to
the exact host backend (itself byte-exact vs the reference binary — see
test_golden_exact.py), deterministically. Runs on the CPU XLA backend in CI;
the same code path runs on the GPU in chip_smoke.py.

A subset of the golden matrix is used (each distinct shape/preset compiles a
device program; the full matrix lives in test_golden_exact.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import signals  # noqa: E402
from srla_tpu import decode, encode  # noqa: E402

N = 20480

CASES = [
    ("sine_p4", "sine", 1, 16, dict(preset=4)),
    ("noise_p2", "white_noise", 1, 16, dict(preset=2)),
    ("stereo_noise_p4", "white_noise", 2, 16, dict(preset=4)),
    ("stereo_sine_p2", "sine", 2, 16, dict(preset=2)),
    ("gauss_p6", "gaussian_noise", 2, 16, dict(preset=6)),
    ("24bit_stereo_p4", "white_noise", 2, 24, dict(preset=4)),
    ("8bit_noise_p2", "white_noise", 1, 8, dict(preset=2)),
    ("impulse_p4", "tiny_impulse", 1, 16, dict(preset=4)),
    ("lshift_p4", "lshifted_sine", 1, 16, dict(preset=4)),
    ("sine_p0", "sine", 1, 16, dict(preset=0)),
    ("8ch_noise_p2", "white_noise", 8, 16, dict(preset=2)),
    # Variable blocks: device-exact span measurement feeds the Dijkstra DP.
    ("vblock_noise_V2", "white_noise", 1, 16, dict(preset=4,
                                                   variable_divisions=2)),
    # LTP on device: df64 pitch detect (scan state machine) + Cholesky +
    # quantize with boundary flags, then the integer LTP filter feeds the
    # LPC chain (kernels/exact.py _ltp_exact).
    ("ltp_p4_P3", "pitchy", 1, 16, dict(preset=4, ltp_order=3)),
    ("ltp_p4_P1_stereo", "pitchy", 2, 16, dict(preset=4, ltp_order=1)),
    ("ltp_vblock_P3_V1", "pitchy", 2, 16, dict(preset=2, ltp_order=3,
                                               variable_divisions=1)),
    # SVR on device: df64 covariance/Cholesky/margin-iteration refinement
    # with objective-comparison and quantize-conditioning flags
    # (kernels/exact.py _svr_exact).
    ("svr_p2_s2", "chirp", 2, 16, dict(preset=2, svr_iterations=2)),
    ("svr_p4_s1", "white_noise", 2, 16, dict(preset=4, svr_iterations=1)),
    ("svr_ltp_s2_P1", "pitchy", 1, 16, dict(preset=2, svr_iterations=2,
                                            ltp_order=1)),
]


@pytest.mark.parametrize("name,sig,ch,bps,kwargs",
                         CASES, ids=[c[0] for c in CASES])
def test_tpu_backend_byte_exact(name, sig, ch, bps, kwargs):
    pcm = signals.ALL[sig](N, ch, bps)
    want = encode(pcm, bps, 44100, backend="exact", **kwargs)
    got = encode(pcm, bps, 44100, backend="tpu", **kwargs)
    assert got == want, f"{name}: tpu stream != exact stream"
    hdr, out = decode(got)
    assert np.array_equal(out, pcm)


def test_tpu_backend_deterministic():
    pcm = signals.ALL["white_noise"](N, 2, 16)
    a = encode(pcm, 16, 44100, preset=4, backend="tpu")
    b = encode(pcm, 16, 44100, preset=4, backend="tpu")
    assert a == b


def test_fallbacks_are_counted():
    """No silent capability holes: every CLI-reachable config now has a
    device pipeline (LTP and SVR included) and the per-path block counts
    must account for every COMPRESS block."""
    from srla_tpu.encoder import EncodeParameter, SRLAEncoder
    pcm = signals.ALL["pitchy"](N, 1, 16)
    for extra in (dict(ltp_order=3), dict(num_svr_filter_learning_iteration=2),
                  dict(ltp_order=1, num_svr_filter_learning_iteration=1)):
        p = EncodeParameter(num_channels=1, bits_per_sample=16,
                            sampling_rate=44100,
                            min_num_samples_per_block=4096,
                            max_num_samples_per_block=4096,
                            num_lookahead_samples=4096, preset=4, **extra)
        enc = SRLAEncoder(p, backend="tpu")
        assert not enc.stats["device_unsupported_config"]
        enc.encode_whole(pcm)
        assert enc.stats["device_blocks"] > 0
        assert (enc.stats["device_blocks"] + enc.stats["host_blocks"]
                + enc.stats["repaired_blocks"]) >= N // 4096
