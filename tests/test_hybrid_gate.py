"""Hybrid scheduler net-contribution gate (encoder._encode_group_hybrid).

The device pipeline's host-side glue competes with the jax-free host worker
for CPU. When the device share is net-negative (blocks returned <
host_rate * cpu_burned), the gate must stop feeding the device — and the
stream must be byte-identical either way (any work split yields the same
bytes; see encoder.py hybrid docstring).
"""

import time

import numpy as np
import pytest

from srla_tpu.encoder import EncodeParameter, SRLAEncoder


def _pcm(seconds, rate=44100, seed=11):
    n = int(seconds * rate)
    t = np.arange(n) / rate
    rng = np.random.RandomState(seed)
    sig = (np.sin(2 * np.pi * 196.0 * t) * 0.4
           + np.sin(2 * np.pi * 392.0 * t + 0.2) * 0.2
           + rng.randn(n) * 0.03)
    l = np.round(np.clip(sig, -1, 1) * 21000).astype(np.int32)
    r = np.round(np.clip(np.roll(sig, 9) * 0.9, -1, 1) * 21000).astype(
        np.int32)
    return np.stack([l, r])


@pytest.fixture
def param():
    return EncodeParameter(num_channels=2, bits_per_sample=16,
                           sampling_rate=44100, preset=2)


def test_gate_stops_net_negative_device(param, monkeypatch):
    """A glue-heavy fake device gets probed, then dropped; bytes match the
    pure host path and the device never consumes more than the probes."""
    monkeypatch.delenv("SRLA_TPU_HOST_SHARE", raising=False)
    pcm = _pcm(20.0)
    n = param.max_num_samples_per_block
    spans = [(off, n) for off in range(0, pcm.shape[1] - n + 1, n)]
    idxs = list(range(len(spans)))
    assert len(idxs) >= 192, "need enough blocks to engage the hybrid"

    enc_ref = SRLAEncoder(param, backend="exact")
    ref = enc_ref._encode_host_batch(pcm, spans, idxs, n, 0)

    enc = SRLAEncoder(param, backend="exact")
    dev_chunks = []

    def fake_dispatch(pcm_, spans_, chunk, size, lshift):
        dev_chunks.append(list(chunk))
        return list(chunk)

    def fake_finish(chunk, pcm_, spans_, size, lshift):
        # Net-negative device: burn CPU (the glue cost the gate measures)
        # and deliver slowly relative to the host worker.
        t0 = time.process_time()
        x = 1.0
        while time.process_time() - t0 < 1.0:
            x = x * 1.0000001 + 1e-9
        time.sleep(0.2)
        return {i: ref[i] for i in chunk}

    monkeypatch.setattr(enc, "_device_dispatch", fake_dispatch)
    monkeypatch.setattr(enc, "_device_finish", fake_finish)

    out = enc._encode_group_hybrid(pcm, spans, idxs, n, 0)
    assert out == ref, "hybrid stream differs from the host path"
    # Probe chunks are 128 blocks; after two net-negative completions the
    # gate must stop taking work (allow the two probes plus one in-flight).
    assert len(dev_chunks) <= 3, f"gate failed to stop device: {dev_chunks}"
    assert sum(len(c) for c in dev_chunks) <= 3 * 128


def test_gate_keeps_net_positive_device(param, monkeypatch):
    """A cheap, fast fake device keeps receiving work (no false trip)."""
    monkeypatch.delenv("SRLA_TPU_HOST_SHARE", raising=False)
    pcm = _pcm(20.0)
    n = param.max_num_samples_per_block
    spans = [(off, n) for off in range(0, pcm.shape[1] - n + 1, n)]
    idxs = list(range(len(spans)))

    enc_ref = SRLAEncoder(param, backend="exact")
    ref = enc_ref._encode_host_batch(pcm, spans, idxs, n, 0)

    enc = SRLAEncoder(param, backend="exact")
    dev_blocks = []

    def fake_dispatch(pcm_, spans_, chunk, size, lshift):
        return list(chunk)

    def fake_finish(chunk, pcm_, spans_, size, lshift):
        dev_blocks.extend(chunk)
        return {i: ref[i] for i in chunk}

    monkeypatch.setattr(enc, "_device_dispatch", fake_dispatch)
    monkeypatch.setattr(enc, "_device_finish", fake_finish)

    out = enc._encode_group_hybrid(pcm, spans, idxs, n, 0)
    assert out == ref
    assert len(dev_blocks) >= 128, "device starved despite zero glue cost"


def test_hung_device_does_not_stall_encode(param, monkeypatch):
    """A device whose first finish never returns (a hung device op) must not
    stall the encode: the host races the device-held blocks and the call
    returns the full byte-exact stream. The abandoned worker runs on a
    DAEMON thread, so it cannot block interpreter exit either
    (encoder._DaemonTask — cf.ThreadPoolExecutor would be joined at exit)."""
    import threading

    monkeypatch.delenv("SRLA_TPU_HOST_SHARE", raising=False)
    pcm = _pcm(20.0)
    n = param.max_num_samples_per_block
    spans = [(off, n) for off in range(0, pcm.shape[1] - n + 1, n)]
    idxs = list(range(len(spans)))

    enc_ref = SRLAEncoder(param, backend="exact")
    ref = enc_ref._encode_host_batch(pcm, spans, idxs, n, 0)

    enc = SRLAEncoder(param, backend="exact")
    hang = threading.Event()  # never set: the fake device op never returns

    def fake_dispatch(pcm_, spans_, chunk, size, lshift):
        return list(chunk)

    def fake_finish(chunk, pcm_, spans_, size, lshift):
        hang.wait()  # simulates a jax fetch that never returns
        return {}

    monkeypatch.setattr(enc, "_device_dispatch", fake_dispatch)
    monkeypatch.setattr(enc, "_device_finish", fake_finish)

    done: dict = {}

    def run():
        done["out"] = enc._encode_group_hybrid(pcm, spans, idxs, n, 0)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120.0)
    assert not t.is_alive(), "hybrid encode stalled on a hung device"
    assert done["out"] == ref, "racing produced a non-byte-exact stream"
    # The stuck worker thread must be a daemon (won't block process exit).
    stuck = [th for th in threading.enumerate()
             if th.name == "srla-dev-worker"]
    assert stuck and all(th.daemon for th in stuck)
