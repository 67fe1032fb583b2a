"""Persistent jax-free host-encode worker subprocess.

The hybrid encoder (encoder.py `_encode_group_hybrid`) splits work between
the device pipeline and the native host path. This module runs the host
side in a persistent subprocess that never imports jax (and is held to the
CPU backend should anything import it), so the native loops do not contend
with the device thread and the jax runtime for the parent's GIL, and the
worker never opens the accelerator; the parent's scheduler thread sleeps on
a pipe read (GIL released) while the worker encodes.

Protocol (pickle frames over stdin/stdout pipes):
  parent -> worker: ("init", param_fields_dict)
                    ("pcm", ndarray)            # new input, once per encode
                    ("job", spans, idxs, size, offset_lshift)
                    ("quit",)
  worker -> parent: ("ok",)                     # after init
                    ("done", {idx: block_bytes}, n_host_blocks)
                    ("err", traceback_string)

Every block is a self-contained unit (reference framing,
`/root/reference/libs/srla_encoder/src/srla_encoder.c:1701-1788`), so the
parent can freely re-encode any outstanding chunk in-thread if the worker
dies — the fallback is correctness-neutral.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import threading

import numpy as np

# One worker per parameter set, shared process-wide (bench encodes the same
# stream repeatedly; re-spawning per encode would pay ~0.5 s import each).
_WORKERS: dict = {}
_LOCK = threading.Lock()
_DISABLED = False  # set after a worker failure: fall back in-thread for good


def _param_key(p) -> tuple:
    return (p.num_channels, p.bits_per_sample, p.sampling_rate, p.preset,
            p.max_num_samples_per_block, p.min_num_samples_per_block,
            p.num_lookahead_samples, p.ltp_order,
            p.num_svr_filter_learning_iteration)


class HostEncodeProc:
    """Handle to one persistent worker. Not thread-safe per instance; the
    hybrid scheduler drives it from a single (main) thread."""

    def __init__(self, param):
        env = dict(os.environ)
        # One process per accelerator: any jax import in the worker stays on
        # the CPU backend.
        env["JAX_PLATFORMS"] = "cpu"
        env["SRLA_TPU_HOST_PROC"] = "0"  # no recursive workers
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             "from srla_tpu.hostproc import _worker_main; _worker_main()"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        self._send(("init", {f: getattr(param, f) for f in (
            "num_channels", "bits_per_sample", "sampling_rate", "preset",
            "max_num_samples_per_block", "min_num_samples_per_block",
            "num_lookahead_samples", "ltp_order",
            "num_svr_filter_learning_iteration")}))
        # Handshake is read lazily at the first result(): the worker spends
        # ~0.5-1 s importing numpy/srla_tpu, and blocking here would stall
        # the hybrid scheduler before the device side even starts.
        self._pending_ok = True
        self._pcm_id = None

    def _send(self, msg) -> None:
        pickle.dump(msg, self.proc.stdin, protocol=pickle.HIGHEST_PROTOCOL)
        self.proc.stdin.flush()

    def _recv(self):
        return pickle.load(self.proc.stdout)

    def _recv_ok(self) -> None:
        msg = self._recv()
        if msg[0] != "ok":
            raise RuntimeError(f"host worker init failed: {msg}")

    def set_pcm(self, pcm: np.ndarray) -> None:
        """Ship the input once per encode_whole. Identity-keyed: repeated
        encodes of the same array object reuse the worker's copy (the held
        reference keeps the id from being recycled by the allocator)."""
        if pcm is self._pcm_id:
            return
        self._send(("pcm", np.ascontiguousarray(pcm)))
        self._pcm_id = pcm

    def submit(self, spans, idxs, size, offset_lshift) -> None:
        self._send(("job", list(spans), list(idxs), int(size),
                    int(offset_lshift)))

    def result(self):
        """Blocks on the pipe (GIL released) until the worker finishes.
        Returns ({idx: bytes}, n_host_blocks)."""
        if self._pending_ok:
            self._recv_ok()
            self._pending_ok = False
        msg = self._recv()
        if msg[0] != "done":
            raise RuntimeError(f"host worker error: {msg[1] if len(msg) > 1 else msg}")
        return msg[1], msg[2]

    def alive(self) -> bool:
        return self.proc.poll() is None

    def close(self) -> None:
        try:
            if self.alive():
                self._send(("quit",))
                self.proc.wait(timeout=2)
        except Exception:
            self.proc.kill()


def get_worker(param):
    """Shared worker for this parameter set, or None when disabled/broken.
    SRLA_TPU_HOST_PROC=0 disables the subprocess path (in-thread encode)."""
    global _DISABLED
    if _DISABLED or os.environ.get("SRLA_TPU_HOST_PROC", "") == "0":
        return None
    key = _param_key(param)
    with _LOCK:
        w = _WORKERS.get(key)
        if w is not None and w.alive():
            return w
        try:
            w = HostEncodeProc(param)
        except Exception:
            _DISABLED = True
            return None
        _WORKERS[key] = w
        return w


def mark_broken(param) -> None:
    """Called by the scheduler when a worker round-trips an error: kill it
    and stop using subprocess workers for the rest of the process."""
    global _DISABLED
    _DISABLED = True
    with _LOCK:
        w = _WORKERS.pop(_param_key(param), None)
    if w is not None:
        try:
            w.proc.kill()
        except Exception:
            pass


def _shutdown_all() -> None:
    with _LOCK:
        ws = list(_WORKERS.values())
        _WORKERS.clear()
    for w in ws:
        w.close()


import atexit  # noqa: E402

atexit.register(_shutdown_all)


def _worker_main() -> None:  # pragma: no cover - subprocess entry
    """Worker loop: build the encoder once, then encode job chunks with the
    exact host path. stdout carries only pickle frames (stderr is inherited
    for diagnostics)."""
    import traceback

    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    enc = None
    pcm = None
    while True:
        try:
            msg = pickle.load(stdin)
        except EOFError:
            return
        try:
            if msg[0] == "quit":
                return
            if msg[0] == "init":
                from srla_tpu.encoder import EncodeParameter, SRLAEncoder
                enc = SRLAEncoder(EncodeParameter(**msg[1]), backend="exact")
                pickle.dump(("ok",), stdout,
                            protocol=pickle.HIGHEST_PROTOCOL)
            elif msg[0] == "pcm":
                pcm = msg[1]
            elif msg[0] == "job":
                _, spans, idxs, size, offset_lshift = msg
                enc.stats["host_blocks"] = 0
                out = enc._encode_host_batch(pcm, spans, idxs, size,
                                             offset_lshift)
                pickle.dump(("done", out, enc.stats["host_blocks"]), stdout,
                            protocol=pickle.HIGHEST_PROTOCOL)
            else:
                pickle.dump(("err", f"unknown message {msg[0]!r}"), stdout,
                            protocol=pickle.HIGHEST_PROTOCOL)
        except Exception:
            pickle.dump(("err", traceback.format_exc()), stdout,
                        protocol=pickle.HIGHEST_PROTOCOL)
        stdout.flush()
