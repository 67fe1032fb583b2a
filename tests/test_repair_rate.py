"""Bound the df64 boundary-flag (host repair) rate on realistic content.

The exact device pipeline re-derives boundary-flagged blocks on the host:
always byte-exact, but a flag-rate regression would silently turn the
device path into a glue-cost generator. This pins the rate on
realistic music-like content — including the LTP pitch path, whose margins
are the widest flag surface — so a margin mis-scale cannot land unnoticed.

Known inherently boundary-dense content is documented (not asserted
against): ideal square waves make the stereo SIDE channel a sparse pulse
train whose autocorrelation has mathematically exact ties at adjacent
lags; the host breaks those ties with its own f64-FFT rounding noise,
which no exact evaluator can predict, so 100% flagging there is the
correct behavior (see NOTES.md round-4 entry).
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "evaluation"))

from srla_tpu.encoder import EncodeParameter, SRLAEncoder  # noqa: E402


def _corpus_file(name: str, seconds: float):
    import tempfile

    from evaluate_codecs import synthetic_corpus
    from srla_tpu.wavio import read_wav
    with tempfile.TemporaryDirectory() as d:
        files = synthetic_corpus(d, seconds)
        path = [f for f in files if os.path.basename(f).startswith(name)][0]
        return np.asarray(read_wav(path).pcm, np.int32)


@pytest.mark.parametrize("name,ltp", [("vocal", 3), ("classic", 0)])
def test_repair_rate_bounded_on_music(name, ltp):
    # vocal_1 with -P 3 exercises the pitch/LTP margins (the widest flag
    # surface); classic_1 the plain LPC chain. 8 s = 86 blocks at B=4096.
    pcm = _corpus_file(name, 8.0)
    param = EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=44100, preset=4,
        max_num_samples_per_block=4096, min_num_samples_per_block=4096,
        num_lookahead_samples=4 * 4096, ltp_order=ltp)
    os.environ["SRLA_TPU_HOST_SHARE"] = "0"   # route everything device-side
    try:
        enc = SRLAEncoder(param, backend="tpu")
        enc.encode_whole(pcm)
    finally:
        del os.environ["SRLA_TPU_HOST_SHARE"]
    dev = enc.stats["device_blocks"] + enc.stats["repaired_blocks"]
    assert dev > 0, f"no blocks reached the device path: {enc.stats}"
    ratio = enc.stats["repaired_blocks"] / dev
    assert ratio <= 0.02, (
        f"df64 repair rate {100 * ratio:.1f}% on {name} (-P {ltp}) "
        f"exceeds the 2% budget: {enc.stats}")
