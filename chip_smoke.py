#!/usr/bin/env python3
"""Smoke check of the codec's device path on one GPU.

Drives the main path once through the entry points a user calls, at the
BASELINE matched point: 120 s of stereo 16-bit 44.1 kHz music-like signal
(`bench.make_music`, fixed seed), 21 MB of PCM. Phases, in order, each
printing one line with the card's name and power limit beside its times:

  device  the JAX device, nvidia-smi, JAX version, compile-cache directory
  df64    the df64 error-free transforms, exact on ~1M elements on the card
  encode  `-m 4 -B 4096 -V 0` and `-m 4 -B 4096 -P 3`: device-only and
          hybrid encodes byte-identical to backend="exact"
  decode  SRLADecoder(backend="tpu") to host and device-resident PCM,
          lossless
  cli     `python -m srla_tpu.cli -e/-d --backend tpu`, in this process
  kernel  the LPC synthesis kernel vs decode2._lpc_scan at real shapes

With --ab, phases encode, decode and kernel also time each platform choice
against its alternative: the flat vs the scatter residual pack, the LPC
kernel vs the XLA scan and the unrolled vs the rolled 32-bit machine end to
end in decode, and the kernel's row tiles. Each alternative compiles its
own programs, so --ab adds minutes of compile.

The last line of stdout is one JSON object naming the device. Any failure
exits non-zero without it; with no GPU the script stops at once.

  python chip_smoke.py                 # the phases above, one GPU
  python chip_smoke.py --ab            # ... plus the platform-choice A/Bs
  python chip_smoke.py --multi 4       # the four-card corpus path only
  python chip_smoke.py --only kernel   # a subset of the phases
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SECONDS = 120.0
RATE = 44100
PHASES = ("device", "df64", "encode", "decode", "cli", "kernel")
CONFIGS = (("-m 4 -B 4096 -V 0", dict(preset=4, max_block=4096)),
           ("-m 4 -B 4096 -P 3", dict(preset=4, max_block=4096,
                                      ltp_order=3)))


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def say(phase: str, card: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body} | card: {card}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def timed(fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    return out, time.perf_counter() - t0


@contextmanager
def env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def param(C: int, preset=4, max_block=4096, ltp_order=0):
    from srla_tpu.encoder import EncodeParameter
    return EncodeParameter(
        num_channels=C, bits_per_sample=16, sampling_rate=RATE,
        preset=preset, max_num_samples_per_block=max_block,
        min_num_samples_per_block=max_block,
        num_lookahead_samples=4 * max_block, ltp_order=ltp_order)


# -- phases ---------------------------------------------------------------


def phase_device(ctx) -> None:
    import jax

    from srla_tpu import kernels
    d = jax.devices()[0]
    say("device", ctx["card"], kind=repr(d.device_kind), count=len(
        jax.devices()), jax=jax.__version__, cache=(
        jax.config.jax_compilation_cache_dir or "off"),
        cache_env=bool(os.environ.get("JAX_COMPILATION_CACHE_DIR")),
        default_cache=kernels.CACHE_DIR)


def phase_df64(ctx) -> None:
    import jax

    from srla_tpu.kernels import df64
    rng = np.random.default_rng(1234)
    N = 1 << 20
    a = rng.uniform(-1e6, 1e6, N).astype(np.float32)
    b = rng.uniform(-1e6, 1e6, N).astype(np.float32)
    big = rng.uniform(-1e8, 1e8, N).astype(np.float32)
    small = rng.uniform(-1e-3, 1e-3, N).astype(np.float32)
    x = rng.integers(-(2 ** 31), 2 ** 31, N, dtype=np.int32)

    @jax.jit
    def eft(a, b, big, small, x):
        # Installed as the device programs install it (kernels/exact.py).
        with df64.pinned(a[0]):
            return (df64.two_prod(a, b), df64.two_sum(big, small),
                    df64.from_int32(x))

    (out, dt) = timed(lambda: jax.block_until_ready(eft(a, b, big, small,
                                                        x)))
    (p, e), (s, se), (hi, lo) = [[np.asarray(v, np.float64) for v in t]
                                 for t in out]
    bad = {
        "two_prod": int(np.sum(p + e != a.astype(np.float64) * b)),
        "two_sum": int(np.sum(s + se != big.astype(np.float64) + small)),
        "from_int32": int(np.sum(hi + lo != x.astype(np.float64))),
    }
    say("df64", ctx["card"], n=N, mismatches=bad, seconds=round(dt, 3))
    check(not any(bad.values()), f"df64 transforms inexact on GPU: {bad}")


def phase_encode(ctx) -> None:
    from srla_tpu import encode
    from srla_tpu.encoder import SRLAEncoder
    pcm = ctx["pcm"]
    C, N = pcm.shape
    ctx["streams"] = {}
    for name, kw in CONFIGS:
        want, t_exact = timed(encode, pcm, 16, RATE, backend="exact", **kw)
        ctx["streams"][name] = want
        p = param(C, **kw)

        def run(x=pcm, ref=want, **envs):
            with env(**envs):
                enc = SRLAEncoder(p, backend="tpu")
                got, dt = timed(enc.encode_whole, x)
            check(got == ref, f"{name} {envs}: stream != backend=exact")
            return enc.stats, dt

        # Device-only first: the device path compiles here, and every full
        # block must go through it (host blocks: repaired ones + the tail).
        _, cold = run(SRLA_TPU_HOST_SHARE="0")
        st, warm = run(SRLA_TPU_HOST_SHARE="0")
        on_host = (st["host_blocks"] - st["repaired_blocks"]
                   - st["w_overflow_blocks"])
        check(on_host == int(N % 4096 > 0),
              f"{name} device-only: a full block skipped the device ({st})")
        say("encode", ctx["card"], config=repr(name), mode="device-only",
            pack=SRLAEncoder._pack_impl(), byte_identical=True,
            cold_s=round(cold, 3), warm_s=round(warm, 3),
            device_blocks=st["device_blocks"], host_blocks=st["host_blocks"],
            repaired_blocks=st["repaired_blocks"],
            repaired_share=round(st["repaired_blocks"] / (N // 4096), 4))
        if ctx["ab"]:
            alt = "flat" if SRLAEncoder._pack_impl() != "flat" else "scatter"
            _, alt_cold = run(SRLA_TPU_HOST_SHARE="0", SRLA_PACK_IMPL=alt)
            _, alt_warm = run(SRLA_TPU_HOST_SHARE="0", SRLA_PACK_IMPL=alt)
            say("encode", ctx["card"], config=repr(name), mode="device-only",
                pack=alt, byte_identical=True, cold_s=round(alt_cold, 3),
                warm_s=round(alt_warm, 3))
        # The hybrid's device thread takes 128-block probes and then chunks
        # of up to 512 blocks, padded to 128-block compile buckets; compile
        # the two buckets the full-length run did not (set-up, not timed).
        compile_s = {}
        for nb in (128, 256):
            x = pcm[:, :nb * 4096]
            ref = encode(x, 16, RATE, backend="exact", **kw)
            _, compile_s[f"bucket{nb}_cold_s"] = run(
                x, ref, SRLA_TPU_HOST_SHARE="0")
        _, cold = run()
        st, warm = run()
        check(st["device_blocks"] > 0, f"{name}: no block on the device")
        say("encode", ctx["card"], config=repr(name), mode="hybrid",
            byte_identical=True, cold_s=round(cold, 3),
            warm_s=round(warm, 3), exact_host_s=round(t_exact, 3),
            device_blocks=st["device_blocks"],
            host_blocks=st["host_blocks"],
            repaired_blocks=st["repaired_blocks"],
            **{k: round(v, 3) for k, v in compile_s.items()})


@contextmanager
def decode_variant(lpc_impl=None, unroll=None):
    """Swap the platform choices of kernels/decode2 for an A/B, with the
    jit caches cleared on both edges so each variant traces anew."""
    from srla_tpu.kernels import decode2
    patches = []
    if lpc_impl is not None:
        patches.append(mock.patch.object(decode2, "_lpc_impl_default",
                                         lambda: lpc_impl))
    if unroll is not None:
        patches.append(mock.patch.object(decode2, "_unroll_bits_default",
                                         lambda: unroll))
    decode2.decode_blocks_paged.clear_cache()
    for p in patches:
        p.start()
    try:
        yield
    finally:
        for p in patches:
            p.stop()
        decode2.decode_blocks_paged.clear_cache()


def phase_decode(ctx) -> None:
    import jax

    from srla_tpu import encode
    from srla_tpu.decoder import SRLADecoder
    from srla_tpu.kernels import decode2
    pcm = ctx["pcm"]
    streams = ctx.get("streams") or {
        name: encode(pcm, 16, RATE, backend="exact", **kw)
        for name, kw in CONFIGS}
    exp_dev = jax.device_put(pcm)
    jax.block_until_ready(exp_dev)
    default = dict(lpc=decode2._lpc_impl_default(),
                   unroll=decode2._unroll_bits_default())
    # --ab: each platform choice against its alternative on the first
    # stream. (Cold times of the alternatives are their compile seconds plus
    # one decode; the default's cold time is on its line.)
    alts = [("lpc=scan" if default["lpc"] != "scan" else "lpc=kernel",
             dict(lpc_impl="scan" if default["lpc"] != "scan"
                  else "kernel")),
            ("unroll=%s" % (not default["unroll"]),
             dict(unroll=not default["unroll"]))] if ctx["ab"] else []

    def to_host(stream, reps):
        times = []
        for _ in range(reps):
            dec = SRLADecoder(backend="tpu")
            (_, out), dt = timed(dec.decode_whole, stream)
            check(np.array_equal(out, pcm), "device decode not lossless")
            times.append(dt)
        return dec.stats, times

    for name, stream in streams.items():
        st, times = to_host(stream, 3)
        res_times = []
        for _ in range(3):
            dec = SRLADecoder(backend="tpu")
            (ok, rst), dt = timed(dec.decode_whole_device_resident, stream,
                                  (exp_dev, pcm))
            check(ok, "device-resident decode not lossless")
            check(rst["device_blocks"] > 0, "resident: no device block")
            res_times.append(dt)
        say("decode", ctx["card"], config=repr(name), variant="default",
            lpc=default["lpc"], unroll=default["unroll"], lossless=True,
            resident_ok=True, cold_s=round(times[0], 3),
            warm_s=round(min(times[1:]), 3),
            resident_cold_s=round(res_times[0], 3),
            resident_warm_s=round(min(res_times[1:]), 3),
            device_blocks=st["device_blocks"], host_blocks=st["host_blocks"])
        for label, kw in alts if name == CONFIGS[0][0] else ():
            with decode_variant(**kw):
                _, times = to_host(stream, 3)
            say("decode", ctx["card"], config=repr(name), variant=label,
                lossless=True, cold_s=round(times[0], 3),
                warm_s=round(min(times[1:]), 3))


def phase_cli(ctx) -> None:
    import filecmp

    from srla_tpu import cli
    from srla_tpu.wavio import WavData, write_wav
    with tempfile.TemporaryDirectory() as d:
        wav = os.path.join(d, "in.wav")
        write_wav(wav, WavData(ctx["pcm"], RATE, 16))
        f = {k: os.path.join(d, k) for k in ("exact.srl", "dev.srl",
                                            "out.wav")}
        flags = ["-m", "4", "-B", "4096", "-V", "0"]
        times = {}
        for key, argv in (
                ("exact_e", ["-e", *flags, wav, f["exact.srl"]]),
                ("tpu_e", ["-e", *flags, "--backend", "tpu", wav,
                           f["dev.srl"]]),
                ("tpu_d", ["-d", "--backend", "tpu", f["dev.srl"],
                           f["out.wav"]])):
            rc, times[key] = timed(cli.main, argv)
            check(rc == 0, f"cli {argv} exited {rc}")
        same = filecmp.cmp(f["exact.srl"], f["dev.srl"], shallow=False)
        lossless = filecmp.cmp(wav, f["out.wav"], shallow=False)
        say("cli", ctx["card"], stream_cmp=same, wav_cmp=lossless,
            **{k + "_s": round(v, 3) for k, v in times.items()})
        check(same and lossless, "cli round trip differs")


def phase_kernel(ctx) -> None:
    import jax
    import jax.numpy as jnp

    from srla_tpu.kernels.decode2 import _align_coefs, _lpc_scan
    from srla_tpu.kernels.pallas_lpc import ROWS, lpc_synthesis
    nblk = int(SECONDS * RATE) // 4096
    shapes = [("B4096", 2 * nblk, 4096, 64), ("B8192", 2 * (nblk // 2), 8192,
                                             16), ("M256", 2 * nblk, 4096, 256)]
    for label, R, n, M in shapes:
        rng = np.random.RandomState(R + n + M)
        res = jnp.asarray(rng.randint(-4000, 4000, (R, n)), jnp.int32)
        orders = rng.randint(0, M + 1, R).astype(np.int32)
        orders[0] = 0
        orders[2] = M
        coefs = rng.randint(-(1 << 15), 1 << 15, (R, M)).astype(np.int32)
        rsh = rng.randint(0, 15, R).astype(np.int32)
        rsh[1] = 0
        orders, rsh = jnp.asarray(orders), jnp.asarray(rsh)
        al = _align_coefs(jnp.asarray(coefs), orders, M)
        dc = jnp.asarray(rng.randint(0, 16, R), jnp.int32)
        dp = jnp.asarray(rng.randint(-30000, 30000, R), jnp.int32)

        def bench(fn):
            out, cold = timed(lambda: jax.block_until_ready(fn()))
            warm = min(timed(lambda: jax.block_until_ready(fn()))[1]
                       for _ in range(3))
            return np.asarray(out), cold, warm

        scan = jax.jit(lambda r, a, o, s, c, p: _lpc_scan(
            r, a, o, s, n, M, dcoef=c, dprev=p))
        want, s_cold, s_warm = bench(lambda: scan(res, al, orders, rsh,
                                                  dc, dp))
        times = {}
        tiles = (ROWS, 64, 128) if ctx["ab"] and label == "B4096" else (ROWS,)
        for rows in tiles:
            kern = jax.jit(lambda r, a, o, s, c, p: lpc_synthesis(
                r, a, o, s, n, M, c, p, rows=rows))
            got, k_cold, k_warm = bench(lambda: kern(res, al, orders, rsh,
                                                     dc, dp))
            check(np.array_equal(got, want),
                  f"kernel (rows={rows}) != _lpc_scan at {label}")
            times[f"kernel_r{rows}_cold_s"] = round(k_cold, 4)
            times[f"kernel_r{rows}_warm_ms"] = round(1e3 * k_warm, 3)
        say("kernel", ctx["card"], shape=label, R=R, n=n, M=M, equal=True,
            scan_cold_s=round(s_cold, 4), scan_warm_ms=round(1e3 * s_warm, 3),
            **times)


def phase_multi(ctx, ndev: int) -> None:
    """Four-card corpus path: encode_corpus_sharded/decode_corpus_sharded
    over a 1-D mesh, against the single-device exact path."""
    import jax

    from bench import make_music
    from srla_tpu import encode
    from srla_tpu.parallel import (decode_corpus_sharded,
                                   encode_corpus_sharded, make_mesh)
    devs = jax.devices()
    check(len(devs) >= ndev, f"need {ndev} GPUs, have {len(devs)}")
    files = [make_music(SECONDS, RATE, seed=7 + i) for i in range(ndev)]
    mesh = make_mesh(ndev)
    enc_st: dict = {}
    dec_st: dict = {}
    with env(SRLA_TPU_HOST_SHARE="0"):
        streams, t_enc_cold = timed(encode_corpus_sharded, mesh, files, 16,
                                    RATE, preset=4, max_block=4096,
                                    stats_out=enc_st)
    for i, (pcm, s) in enumerate(zip(files, streams)):
        want = encode(pcm, 16, RATE, preset=4, max_block=4096,
                      backend="exact")
        check(s == want, f"file {i}: sharded stream != exact stream")
    say("multi", ctx["card"], step="encode", byte_identical=True,
        shard_rows=enc_st.get("shard_rows"),
        shard_devices=enc_st.get("shard_devices"),
        encode_cold_s=round(t_enc_cold, 3))
    decoded, t_dec_cold = timed(decode_corpus_sharded, mesh, streams,
                                stats_out=dec_st)
    decoded, t_dec = timed(decode_corpus_sharded, mesh, streams,
                           stats_out=dec_st)
    for i, (pcm, back) in enumerate(zip(files, decoded)):
        check(np.array_equal(back, pcm), f"file {i}: decode not lossless")
    for name, st in (("encode", enc_st), ("decode", dec_st)):
        rows, on = st.get("shard_rows"), st.get("shard_devices")
        check(rows is not None and len(rows) == ndev
              and len(set(rows)) == 1 and rows[0] > 0,
              f"{name} shards unbalanced or missing: {rows}")
        check(on is not None and len(set(on)) == ndev,
              f"{name} shards not on {ndev} devices: {on}")
    peak = [(d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in devs[:ndev]]
    say("multi", ctx["card"], step="decode", devices=ndev, files=ndev,
        byte_identical=True, lossless=True,
        enc_shard_rows=enc_st["shard_rows"],
        dec_shard_rows=dec_st["shard_rows"],
        enc_shard_devices=enc_st["shard_devices"],
        dec_shard_devices=dec_st["shard_devices"],
        decode_cold_s=round(t_dec_cold, 3), decode_warm_s=round(t_dec, 3),
        peak_bytes=peak)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", type=int, default=0, metavar="N",
                    help="run only the N-card corpus path")
    ap.add_argument("--only", nargs="+", choices=PHASES, default=PHASES,
                    help="run only these phases")
    ap.add_argument("--ab", action="store_true",
                    help="also time each platform choice against its "
                    "alternative")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from bench import make_music

    import srla_tpu.kernels  # noqa: F401  (configures the compile cache)
    card = gpu_line()
    print(f"card: {card}", flush=True)
    ctx = {"card": card, "ab": args.ab}
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(ctx, args.multi)
        count = args.multi
    else:
        ctx["pcm"] = make_music(SECONDS, RATE)
        for name in PHASES:
            if name in args.only:
                t = time.perf_counter()
                globals()["phase_" + name](ctx)
                print(f"[{name}] phase_s={time.perf_counter() - t:.1f}",
                      flush=True)
        count = len(devs)
    print(f"total_s={time.perf_counter() - t0:.1f} | card: {card}",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
