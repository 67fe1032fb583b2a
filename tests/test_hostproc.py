"""Jax-free host-encode worker subprocess (srla_tpu/hostproc.py).

The hybrid scheduler offloads its host share to a persistent subprocess so
the native encode loops do not contend for the GIL with the device thread
and the jax runtime. Correctness contract: the worker's blocks are byte-identical to
the in-thread host path, and a dead worker degrades to in-thread encoding
without changing the stream.
"""

import numpy as np
import pytest

from srla_tpu import hostproc
from srla_tpu.encoder import EncodeParameter, SRLAEncoder


def _pcm(seconds=4.0, rate=44100, seed=3):
    n = int(seconds * rate)
    t = np.arange(n) / rate
    rng = np.random.RandomState(seed)
    sig = (np.sin(2 * np.pi * 220.0 * t) * 0.4
           + np.sin(2 * np.pi * 440.0 * t + 0.3) * 0.2
           + rng.randn(n) * 0.02)
    l = np.round(np.clip(sig, -1, 1) * 20000).astype(np.int32)
    r = np.round(np.clip(np.roll(sig, 7) * 0.9, -1, 1) * 20000).astype(
        np.int32)
    return np.stack([l, r])


@pytest.fixture
def param():
    return EncodeParameter(num_channels=2, bits_per_sample=16,
                           sampling_rate=44100, preset=4)


def test_worker_blocks_byte_identical(param, monkeypatch):
    monkeypatch.delenv("SRLA_TPU_HOST_PROC", raising=False)
    hostproc._DISABLED = False
    pcm = _pcm()
    enc = SRLAEncoder(param, backend="exact")
    n = param.max_num_samples_per_block
    spans = [(off, n) for off in range(0, pcm.shape[1] - n + 1, n)]
    idxs = list(range(len(spans)))
    ref = enc._encode_host_batch(pcm, spans, idxs, n, 0)

    w = hostproc.get_worker(param)
    assert w is not None and w.alive()
    w.set_pcm(pcm)
    w.submit(spans, idxs, n, 0)
    out, n_host = w.result()
    assert out == ref
    assert n_host == len(idxs)

    # Cached-pcm resubmit (same array object) still matches.
    w.set_pcm(pcm)
    w.submit(spans, idxs[:3], n, 0)
    out2, _ = w.result()
    assert out2 == {i: ref[i] for i in idxs[:3]}


def test_worker_shared_and_disable_knob(param, monkeypatch):
    hostproc._DISABLED = False
    monkeypatch.delenv("SRLA_TPU_HOST_PROC", raising=False)
    w1 = hostproc.get_worker(param)
    w2 = hostproc.get_worker(param)
    assert w1 is w2  # persistent, shared per parameter set
    monkeypatch.setenv("SRLA_TPU_HOST_PROC", "0")
    assert hostproc.get_worker(param) is None


def test_dead_worker_falls_back_in_stream(param, monkeypatch):
    """Kill the worker mid-encode setup: the hybrid path must produce the
    identical stream via the in-thread fallback."""
    monkeypatch.setenv("SRLA_TPU_HOST_PROC", "0")
    pcm = _pcm(seconds=2.0)
    ref_stream = SRLAEncoder(param, backend="exact").encode_whole(pcm)

    monkeypatch.delenv("SRLA_TPU_HOST_PROC", raising=False)
    hostproc._DISABLED = False
    w = hostproc.get_worker(param)
    assert w is not None
    w.proc.kill()
    w.proc.wait()
    # get_worker replaces dead workers transparently...
    w2 = hostproc.get_worker(param)
    assert w2 is not None and w2 is not w and w2.alive()
    # ...and mark_broken disables the path; encode still byte-identical.
    hostproc.mark_broken(param)
    assert hostproc.get_worker(param) is None
    out_stream = SRLAEncoder(param, backend="exact").encode_whole(pcm)
    assert out_stream == ref_stream
    hostproc._DISABLED = False
