#!/usr/bin/env python3
"""Host-backend measurement worker for evaluate_codecs.py.

Runs in a SUBPROCESS held to the CPU backend (the parent sets
``JAX_PLATFORMS=cpu``) so the srla_tpu host path is measured the way it
deploys — a jax-free process — and never opens the accelerator.

Timing is best-of-N with early stop: per file, encode/decode are repeated
until the two fastest runs agree within 25% (max ``repeats`` runs) and the
minimum is reported.

Protocol: job JSON on stdin, one result JSON per file on stdout.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from srla_tpu.decoder import SRLADecoder  # noqa: E402
from srla_tpu.encoder import EncodeParameter, SRLAEncoder  # noqa: E402
from srla_tpu.wavio import read_wav  # noqa: E402


def _stable(times: list) -> bool:
    if len(times) < 2:
        return False
    a, b = sorted(times)[:2]
    return b <= 1.25 * a


def main() -> int:
    job = json.load(sys.stdin)
    cfg = job["cfg"]
    backend = job["backend"]
    repeats = int(job.get("repeats", 3))
    if "jax" in sys.modules:  # pragma: no cover - environment guard
        print("host_worker: jax leaked into the measurement process",
              file=sys.stderr)

    for path in job["files"]:
        wav = read_wav(path)
        pcm = np.asarray(wav.pcm, np.int32)
        duration = pcm.shape[1] / wav.sampling_rate
        raw_size = os.path.getsize(path)
        param = EncodeParameter(
            num_channels=pcm.shape[0], bits_per_sample=wav.bits_per_sample,
            sampling_rate=wav.sampling_rate, preset=cfg["preset"],
            max_num_samples_per_block=cfg["B"],
            min_num_samples_per_block=cfg["B"] >> cfg["V"],
            num_lookahead_samples=cfg["L"] * cfg["B"],
            ltp_order=cfg["P"])

        enc_times, dec_times = [], []
        stream = None
        stats = {}
        for _ in range(repeats):
            enc = SRLAEncoder(param, backend=backend)
            t0 = time.time()
            s = enc.encode_whole(pcm)
            enc_times.append(time.time() - t0)
            if stream is None:
                stream, stats = s, enc.stats
            else:
                assert s == stream, f"non-deterministic encode: {path}"
            dec = SRLADecoder(backend="native")
            t0 = time.time()
            _, out = dec.decode_whole(s)
            dec_times.append(time.time() - t0)
            assert np.array_equal(out, pcm), f"round trip failed: {path}"
            if _stable(enc_times) and _stable(dec_times):
                break

        print(json.dumps({
            "file": path,
            "encode_pct_rt": 100.0 * min(enc_times) / duration,
            "decode_pct_rt": 100.0 * min(dec_times) / duration,
            "compression_pct": 100.0 * len(stream) / raw_size,
            "enc_device_blocks": stats.get("device_blocks", 0),
            "enc_host_blocks": stats.get("host_blocks", 0),
            "enc_repaired_blocks": stats.get("repaired_blocks", 0),
            "dec_device_blocks": 0,
            "dec_host_blocks": 0,
            "sha256": hashlib.sha256(stream).hexdigest(),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
