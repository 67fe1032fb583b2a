#!/usr/bin/env python3
"""Benchmark: encode x-realtime on one device at the BASELINE matched point
(-m 4, B=4096, stereo 16-bit 44.1 kHz), device path.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "x_realtime", "vs_baseline": N}

Baseline (BASELINE.md): reference AVX2 encode at -m 4 -B 4096 runs at
0.366 %RT = 273.2x realtime on one x86 core.
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 1)[0])

BASELINE_ENCODE_XRT = 273.2  # 1 / 0.366% (AVX2, -m 4, B=4096)


def make_music(seconds: float, rate: int = 44100, seed: int = 7) -> np.ndarray:
    """Deterministic music-like stereo signal: harmonics + AM + noise floor."""
    n = int(seconds * rate)
    t = np.arange(n) / rate
    rng = np.random.RandomState(seed)
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 0.25 * t + 0.7)
    sig = env * (np.sin(2 * np.pi * 196.0 * t) * 0.32
                 + np.sin(2 * np.pi * 392.0 * t + 0.3) * 0.17
                 + np.sin(2 * np.pi * 587.3 * t + 1.1) * 0.09
                 + np.sin(2 * np.pi * 1174.7 * t + 0.2) * 0.04)
    sig = sig + rng.randn(n) * 0.035
    left = np.round(np.clip(sig, -1, 1) * 23000).astype(np.int32)
    right = np.round(np.clip(np.roll(sig, 11) * 0.93, -1, 1)
                     * 23000).astype(np.int32)
    return np.stack([left, right])


def _jaxfree_env():
    """Child processes stay on the CPU backend: one process per device."""
    import os
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _exact_host_standalone_xrt(seconds: float) -> float:
    """Best-of-3 exact-host encode in a jax-free subprocess (the host
    path's deployment shape)."""
    import os
    import subprocess
    code = (
        "import sys, time, json; sys.path.insert(0, %r)\n"
        "from bench import make_music\n"
        "from srla_tpu import encode\n"
        "pcm = make_music(%r)\n"
        "ts = []\n"
        "for _ in range(3):\n"
        "    t0 = time.time()\n"
        "    encode(pcm, 16, 44100, preset=4, backend='exact')\n"
        "    ts.append(time.time() - t0)\n"
        "print(json.dumps(min(ts)))\n"
    ) % (os.path.dirname(os.path.abspath(__file__)), seconds)
    out = subprocess.run([sys.executable, "-c", code], env=_jaxfree_env(),
                         capture_output=True, timeout=600, check=True)
    return seconds / json.loads(out.stdout.strip())


def _native_decode_standalone_xrt(stream: bytes, seconds: float) -> float:
    """Best-of-3 native whole-stream decode in a jax-free subprocess — the
    deployed shape of the host decoder."""
    import os
    import subprocess
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".srl", delete=False) as f:
        f.write(stream)
        path = f.name
    code = (
        "import sys, time, json; sys.path.insert(0, %r)\n"
        "from srla_tpu import decode\n"
        "data = open(%r, 'rb').read()\n"
        "ts = []\n"
        "for _ in range(3):\n"
        "    t0 = time.time()\n"
        "    decode(data)\n"
        "    ts.append(time.time() - t0)\n"
        "print(json.dumps(min(ts)))\n"
    ) % (os.path.dirname(os.path.abspath(__file__)), path)
    try:
        out = subprocess.run([sys.executable, "-c", code], env=_jaxfree_env(),
                             capture_output=True, timeout=600, check=True)
    finally:
        os.unlink(path)
    return seconds / json.loads(out.stdout.strip())


def main():
    import jax

    from srla_tpu import decode, encode
    from srla_tpu.decoder import SRLADecoder

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    seconds = 120.0
    rate = 44100
    pcm = make_music(seconds, rate)
    raw_bytes = pcm.shape[1] * pcm.shape[0] * 2 + 44
    backend = "tpu"

    # Warm-up with the full-size input: device programs compile once per
    # shape bucket. The metric is steady-state throughput.
    t_w = time.time()
    encode(pcm, 16, rate, preset=4, backend=backend)
    print(f"bench: warm-up (compile) {time.time() - t_w:.1f}s",
          file=sys.stderr)

    times = []
    for _ in range(5):
        t0 = time.time()
        stream = encode(pcm, 16, rate, preset=4, backend=backend)
        times.append(time.time() - t0)
    encode_xrt = seconds / min(times)

    # Exact host backend row (regression tracking for the CPU path); in
    # exact device mode the streams must be byte-identical.
    stream_exact = encode(pcm, 16, rate, preset=4, backend="exact")
    byte_exact = stream == stream_exact
    # The host path deploys as a jax-free process: measure it as one.
    exact_xrt = _exact_host_standalone_xrt(seconds)

    _, out = decode(stream)
    lossless = np.array_equal(out, pcm)
    decode_xrt = _native_decode_standalone_xrt(stream, seconds)

    # Device decode rows (word-machine entropy + batched synthesis):
    #  - tpu_decode_xrt: decode to DEVICE-RESIDENT PCM, verified bit-exact
    #    on device (one boolean is fetched).
    #  - tpu_decode_e2e_xrt: the same decode with the PCM fetched to host.
    exp_dev = jax.device_put(pcm)
    exp_dev.block_until_ready()
    SRLADecoder(backend="tpu").decode_whole_device_resident(
        stream, (exp_dev, pcm))  # compile
    oks = []
    times_d = []
    for _ in range(3):
        t4 = time.time()
        ok, _st = SRLADecoder(backend="tpu").decode_whole_device_resident(
            stream, (exp_dev, pcm))
        times_d.append(time.time() - t4)
        oks.append(ok)
    tpu_decode_xrt = seconds / min(times_d)
    times_e = []
    for _ in range(3):
        t5 = time.time()
        _, out_tpu = SRLADecoder(backend="tpu").decode_whole(stream)
        times_e.append(time.time() - t5)
    tpu_decode_e2e_xrt = seconds / min(times_e)
    tpu_lossless = all(oks) and bool(np.array_equal(out_tpu, pcm))

    ratio = 100.0 * len(stream) / raw_bytes
    print(f"bench[{dev.device_kind}]: encode {min(times):.2f}s "
          f"({encode_xrt:.1f}x RT), native decode {decode_xrt:.1f}x RT, "
          f"compression {ratio:.2f}%, lossless={lossless}; "
          f"exact-host encode {exact_xrt:.1f}x RT, "
          f"device==host bytes: {byte_exact}",
          file=sys.stderr)
    if not (lossless and tpu_lossless and byte_exact):
        print(json.dumps({"metric": "encode_xrt_m4_b4096", "value": 0.0,
                          "unit": "x_realtime", "vs_baseline": 0.0}))
        return 1

    print(json.dumps({
        "metric": "encode_xrt_m4_b4096",
        "value": round(encode_xrt, 2),
        "unit": "x_realtime",
        "vs_baseline": round(encode_xrt / BASELINE_ENCODE_XRT, 4),
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "decode_xrt": round(decode_xrt, 2),
        "tpu_decode_xrt": round(tpu_decode_xrt, 2),
        "tpu_decode_e2e_xrt": round(tpu_decode_e2e_xrt, 2),
        "tpu_decode_lossless": tpu_lossless,
        "exact_host_xrt": round(exact_xrt, 2),
        "compression_pct": round(ratio, 2),
        "byte_exact_vs_host": bool(byte_exact),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
